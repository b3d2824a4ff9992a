"""rat_tpu_torch — the RAT retrieval-augmented CTR framework in PyTorch.

The PyTorch / CUDA port of ``rat_tpu``. Module names follow the JAX
package so each counterpart is easy to find:

- config, seeding, Monitor -> rat_tpu_torch.utils
- feature map              -> rat_tpu_torch.features
- BM25 retrieval           -> rat_tpu_torch.retrieval
- split loading            -> rat_tpu_torch.data
- NN layers and encoders   -> rat_tpu_torch.nn
- the four RAT variants    -> rat_tpu_torch.models (m2's fused path
                              in models.fast_forward)
- train and eval runtime   -> rat_tpu_torch.engine (Trainer.fit, Adam
                              with global-norm clipping in engine.optim)
- Hopper kernels           -> rat_tpu_torch.ops (sources in csrc/): K1
                              the fused encoder block (differentiable),
                              K2 BM25 top-K, K3 dense BM25 chunk scores

Entry points take ``device=None``, meaning ``"cuda"``; without a CUDA
device they raise instead of falling back to the CPU. Pass
``device="cpu"`` explicitly to run the plain PyTorch versions.

This package imports neither JAX nor ``rat_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference trains in strict float32 (torch default, AMP off), and
# the JAX package pins float32 matmuls for the same reason. TF32 keeps
# about three decimal digits, enough to move AUC: keep it off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
