"""The plain reference that decides ``correct``: BM25 top-K retrieval
(``bm25``), the RAT_m2 model with its loss, clip and Adam (``rat``), and
the numbers by which the program's outputs are judged against it
(``judge``).

Plain PyTorch and NumPy in float32 with TF32 off, written from the
method's published description. It imports nothing of the program: it
works out again, from the inputs the benchmark made, whatever the
program's set-up derived (IDF tables, folds, neighbours, packed tables),
and reads the program's outputs only to judge them.
"""

import torch


def strict_float32():
    """IEEE float32 products on the card: TF32 off for cuBLAS and cuDNN
    (the legacy switches, which the program uses too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
