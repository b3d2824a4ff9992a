"""Parameter initializers matching the reference's reset_parameters
(port of rat_tpu.nn.initializers), drawn from an explicit
``torch.Generator``:

- embedding tables: N(0, 1e-4) with the padding rows kept at zero;
- Linear weights: Xavier/Glorot untruncated normal, zero bias.
"""

import math

import torch


def xavier_normal(generator, shape):
    """Glorot normal; symmetric in fan-in/fan-out, so it serves both the
    flax [in, out] and the torch [out, in] layouts."""
    std = math.sqrt(2.0 / (shape[0] + shape[1]))
    return std * torch.randn(shape, generator=generator)


def embedding_init(generator, shape, std=1.e-4):
    return std * torch.randn(shape, generator=generator)
