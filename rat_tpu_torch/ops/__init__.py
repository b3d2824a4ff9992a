"""Hand-written Hopper kernels (sources in rat_tpu_torch/csrc/), each
beside its plain PyTorch version:

- K1 ``cross_intra_block``: one fused RAT_m2 encoder block, under a
  ``torch.autograd.Function`` whose backward on the card is K1's
  backward kernel (``k1_grad_kernel``), and autograd of the plain
  version where a shape does not take it and on the CPU;
- K2 ``bm25_topk``: fused BM25 score + top-K over the pool;
- K3 ``bm25_score_chunk``: dense BM25 scores against one pool chunk;
- ``embedding_grad``: the embedding lookups' backward (``lookup``, the
  gather under a ``torch.autograd.Function`` whose backward,
  ``table_grad``, is the kernel on the card; plain version
  ``table_grad_reference``);
- ``attention``: softmax attention over short sequences from the packed
  QKV projection, the module encoder's attention core (``attention``;
  on the card an autograd Function whose forward and backward are the
  kernel; plain version ``attention_reference``).

Each module holds the wrapper of the same name, its plain version
(``*_reference``) and the wrapper's ``launches`` count. The package
exports the modules, not the wrappers, so that a wrapper's name does not
hide the module that holds its count.
"""

from . import (attention, bm25_score_chunk, bm25_topk, cross_intra_block,  # noqa: F401
               embedding_grad)
