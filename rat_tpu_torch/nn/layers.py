"""Core NN layers (port of rat_tpu.nn.layers): MLP tower, LR (wide)
tower, transformer primitives.

Parity notes, as in the JAX package:
- GELU is the exact (erf) variant;
- LayerNorm eps 1e-5;
- attention scale is ``dim_head ** -0.5``, and the output projection
  is dropped when ``heads == 1 and dim_head == dim`` (``project_out``).

The JAX package's batch-major and batch-minor attention layouts are TPU
schedules of one math; here the math is written once
(ops/cross_intra_block.py::attention).

Every Linear is built with ``xavier_normal`` weights and zero bias from
the module's ``generator``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cross_intra_block import attention
from .embedding import PackedEmbedding
from .initializers import xavier_normal


def get_activation(name):
    if callable(name):
        return name
    name = name.lower()
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise NotImplementedError("activation={}".format(name))


def linear(in_dim, out_dim, generator, bias=True):
    """nn.Linear with the reference's init: Xavier normal, zero bias."""
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(xavier_normal(generator, (out_dim, in_dim)))
        if bias:
            layer.bias.zero_()
    return layer


class MLPLayer(nn.Module):
    """Dense tower: [Linear, act]* + output Linear (BatchNorm and
    dropout are not ported yet)."""

    def __init__(self, input_dim, output_dim, hidden_units,
                 hidden_activations="relu", generator=None):
        super().__init__()
        self.act = get_activation(hidden_activations)
        dims = [input_dim] + list(hidden_units) + [output_dim]
        self.linears = nn.ModuleList(linear(a, b, generator)
                                     for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for layer in self.linears[:-1]:
            x = self.act(layer(x))
        return self.linears[-1](x)


class LRLayer(nn.Module):
    """Wide/LR tower via the 1-dim-embedding one-hot trick, without bias
    (as RATModel uses it). For a grid input [B, 1+K, F] the per-sample
    logits are averaged over the samples."""

    def __init__(self, spec, generator=None):
        super().__init__()
        self.embedding_layer = PackedEmbedding(spec, 1, generator=generator)

    def forward(self, X_tokens):
        output = self.embedding_layer(X_tokens).sum(dim=-2)     # [..., 1]
        return output.mean(dim=1) if X_tokens.dim() == 3 else output


class FeedForward(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, dim, hidden_dim, generator=None):
        super().__init__()
        self.fc1 = linear(dim, hidden_dim, generator)
        self.fc2 = linear(hidden_dim, dim, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention."""

    def __init__(self, dim, heads=8, dim_head=64, generator=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner_dim = dim_head * heads
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_qkv = linear(dim, inner_dim * 3, generator, bias=False)
        self.to_out = linear(inner_dim, dim, generator) if self.project_out \
            else None

    def forward(self, x):
        return attention(x, self.to_qkv.weight,
                         None if self.to_out is None else self.to_out.weight,
                         None if self.to_out is None else self.to_out.bias,
                         self.heads, self.dim_head, self.project_out)


class PreNormAttention(nn.Module):
    """LayerNorm -> Attention."""

    def __init__(self, dim, heads, dim_head, generator=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads=heads, dim_head=dim_head,
                              generator=generator)

    def forward(self, x):
        return self.attn(self.norm(x))
