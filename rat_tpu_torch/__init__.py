"""rat_tpu_torch — the RAT retrieval-augmented CTR framework in PyTorch.

The PyTorch / CUDA port of ``rat_tpu``. Module names follow the JAX
package so each counterpart is easy to find:

- config, seeding, Monitor -> rat_tpu_torch.utils
- feature map              -> rat_tpu_torch.features
- BM25 retrieval           -> rat_tpu_torch.retrieval (exact match
                              included)
- split loading            -> rat_tpu_torch.data (block streaming in
                              data.block_loader)
- NN layers and encoders   -> rat_tpu_torch.nn
- the four RAT variants    -> rat_tpu_torch.models (m2's fused path
                              in models.fast_forward)
- train and eval runtime   -> rat_tpu_torch.engine (Trainer.fit; Adam
                              and optax's adamw, sgd, adagrad, rmsprop
                              with global-norm clipping in engine.optim)
- Hopper kernels           -> rat_tpu_torch.ops (sources in csrc/): K1
                              the fused encoder block (differentiable),
                              K2 BM25 top-K, K3 dense BM25 chunk scores
- tooling                  -> rat_tpu_torch.autotuner (sweeps),
                              rat_tpu_torch.cli.benchmark and the root
                              bench_torch.py, rat_tpu_torch.cli.chip_health
                              (a GPU stamp), rat_tpu_torch.ops.bench_kernel
- native host encoder      -> rat_tpu_torch.native (C++, built at first use)

``RAT_TPU_MATMUL_PRECISION`` (read at import, default ``float32``)
selects the precision of float32 matrix products as in the JAX package:
see :func:`set_matmul_precision`.

Entry points take ``device=None``, meaning ``"cuda"``; without a CUDA
device they raise instead of falling back to the CPU. Pass
``device="cpu"`` explicitly to run the plain PyTorch versions.

This package imports neither JAX nor ``rat_tpu``.
"""

__version__ = "0.1.0"

import os as _os

import torch as _torch

#: each value of ``RAT_TPU_MATMUL_PRECISION`` that the port accepts, and
#: the ``torch.set_float32_matmul_precision`` setting it selects
MATMUL_PRECISIONS = {"float32": "highest", "highest": "highest",
                     "tensorfloat32": "high", "high": "high",
                     "bfloat16": "high", "default": "high"}


def set_matmul_precision(name):
    """Set the precision of float32 matrix products on CUDA, the port's
    counterpart of ``jax.config.update("jax_default_matmul_precision",
    name)``, which the JAX package calls with the same values:

    - ``float32`` (the default) and ``highest``: IEEE float32
      (``torch.set_float32_matmul_precision("highest")``, TF32 off). The
      reference trains in strict float32, and TF32 keeps about three
      decimal digits of each operand, enough to move AUC.
    - ``tensorfloat32``, ``high``, ``bfloat16`` and ``default``: TF32
      on the tensor cores (``"high"``). Torch offers no bfloat16 pass
      for float32 operands on CUDA: ``"medium"`` also selects TF32
      there, and a ``"bf16"`` matmul precision is refused for the CUDA
      backend. So JAX's reduced settings all become TF32 here.

    Any other value raises ValueError, as JAX does for an unknown one;
    JAX's dot-algorithm names (``BF16_BF16_F32`` and the like) pick an
    XLA dot algorithm, not a precision class, and are refused too.
    cuDNN's TF32 stays off at every setting. Kernel K1 computes in
    float32 FMAs and K2 and K3 in integer matches with float32 sums:
    no setting changes them.

    Only torch's legacy switches are used (``cudnn.allow_tf32`` and
    ``set_float32_matmul_precision``): mixing them with the newer
    ``fp32_precision`` attributes makes torch raise when either is read
    (``cuda.matmul.allow_tf32`` is read by the health stamp)."""
    if name not in MATMUL_PRECISIONS:
        raise ValueError("RAT_TPU_MATMUL_PRECISION={!r} is not one of {}".format(
            name, ", ".join(MATMUL_PRECISIONS)))
    _torch.backends.cudnn.allow_tf32 = False
    _torch.set_float32_matmul_precision(MATMUL_PRECISIONS[name])


set_matmul_precision(_os.environ.get("RAT_TPU_MATMUL_PRECISION", "float32"))
