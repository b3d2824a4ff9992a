"""Core NN layers (port of rat_tpu.nn.layers): BatchNorm, dropout, MLP
tower, LR (wide) tower, transformer primitives.

Parity notes, as in the JAX package:
- GELU is the exact (erf) variant;
- LayerNorm eps 1e-5;
- attention scale is ``dim_head ** -0.5``, and the output projection
  is dropped when ``heads == 1 and dim_head == dim`` (``project_out``);
- BatchNorm normalizes with the biased batch variance and tracks the
  unbiased one (``TorchBatchNorm``);
- dropout scales the kept values by ``1 / (1 - p)``.

The JAX package's batch-major and batch-minor attention layouts are TPU
schedules of one math; here the math is written once
(ops/cross_intra_block.py::attention, and :func:`mhsa` where the head
count and the scale are set apart).

Every Linear is built with ``xavier_normal`` weights and zero bias from
the module's ``generator``. Dropout masks come from the generator that
:func:`set_dropout_generator` gives the model (the global RNG without
one).
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


class Dropout(nn.Module):
    """flax ``nn.Dropout`` semantics: in training, each value is kept
    with probability 1 - p and scaled by 1 / (1 - p); p = 0 and eval
    mode are the identity, p = 1 gives zeros. The mask is drawn from
    ``self.generator`` (set by :func:`set_dropout_generator`)."""

    def __init__(self, p=0.):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.p >= 1:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) < 1 - self.p
        return torch.where(keep, x / (1 - self.p), torch.zeros_like(x))


def set_dropout_generator(module, generator):
    """Draw every dropout mask under ``module`` from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis, as the JAX package's
    ``TorchBatchNorm``: in training, normalize with the batch mean and
    BIASED variance, and move the running mean and the UNBIASED running
    variance (factor n / max(n - 1, 1)) by momentum 0.1 (torch's
    convention; flax's decay 0.9); in eval, normalize with the running
    statistics; eps 1e-5. Unlike ``nn.BatchNorm1d`` it takes a batch of
    one row in training, as the JAX module does. The running statistics
    are buffers."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.square(x - mean).mean(dim=axes)
            n = x.numel() // x.shape[-1]
            decay = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(decay * self.running_mean
                                        + (1.0 - decay) * mean)
                self.running_var.copy_(decay * self.running_var
                                       + (1.0 - decay) * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class MLPLayer(nn.Module):
    """Dense tower: [Linear, BatchNorm?, act, dropout]* + output Linear.
    ``dropout_rates`` is one rate or one per hidden layer."""

    def __init__(self, input_dim, output_dim, hidden_units,
                 hidden_activations="relu", dropout_rates=0., batch_norm=False,
                 generator=None):
        super().__init__()
        drops = dropout_rates if isinstance(dropout_rates, (list, tuple)) \
            else [dropout_rates] * len(hidden_units)
        self.act = get_activation(hidden_activations)
        dims = [input_dim] + list(hidden_units) + [output_dim]
        self.linears = nn.ModuleList(linear(a, b, generator)
                                     for a, b in zip(dims, dims[1:]))
        self.norms = nn.ModuleList(TorchBatchNorm(u) for u in hidden_units) \
            if batch_norm else None
        self.drops = nn.ModuleList(Dropout(p) for p in drops)

    def forward(self, x):
        for i, layer in enumerate(self.linears[:-1]):
            x = layer(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.drops[i](self.act(x))
        return self.linears[-1](x)


class LRLayer(nn.Module):
    """Wide/LR tower via the 1-dim-embedding one-hot trick, without bias
    (as RATModel uses it). For a grid input [B, 1+K, F] the per-sample
    logits are averaged over the samples."""

    def __init__(self, spec, generator=None):
        super().__init__()
        self.embedding_layer = PackedEmbedding(spec, 1, generator=generator)

    def forward(self, X_tokens, X_numeric=None):
        output = self.embedding_layer(X_tokens, X_numeric).sum(dim=-2)   # [..., 1]
        return output.mean(dim=1) if X_tokens.dim() == 3 else output


class FeedForward(nn.Module):
    """Linear -> exact GELU -> dropout -> Linear -> dropout."""

    def __init__(self, dim, hidden_dim, dropout=0., generator=None):
        super().__init__()
        self.fc1 = linear(dim, hidden_dim, generator)
        self.fc2 = linear(hidden_dim, dim, generator)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.drop(F.gelu(self.fc1(x), approximate="none"))
        return self.drop(self.fc2(x))


def mhsa(q, k, v, heads, scale):
    """[n, seq, inner] q, k, v -> [n, seq, inner]: softmax attention in
    ``heads`` heads of width inner / heads, the scores scaled by
    ``scale`` (which RAT_m3 does not tie to the head width)."""
    n, s, inner = q.shape

    def heads_first(t):
        return t.reshape(n, s, heads, -1).transpose(1, 2)

    q, k, v = heads_first(q), heads_first(k), heads_first(v)
    dots = torch.matmul(q, k.transpose(-1, -2)) * scale
    out = torch.matmul(torch.softmax(dots, dim=-1), v)
    return out.transpose(1, 2).reshape(n, s, inner)


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention; dropout after the output
    projection, when there is one."""

    def __init__(self, dim, heads=8, dim_head=64, dropout=0., generator=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner_dim = dim_head * heads
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_qkv = linear(dim, inner_dim * 3, generator, bias=False)
        self.to_out = linear(inner_dim, dim, generator) if self.project_out \
            else None
        self.drop = Dropout(dropout)

    def forward(self, x):
        out = attention(x, self.to_qkv.weight,
                        None if self.to_out is None else self.to_out.weight,
                        None if self.to_out is None else self.to_out.bias,
                        self.heads, self.dim_head, self.project_out)
        return self.drop(out) if self.project_out else out


class PreNormAttention(nn.Module):
    """LayerNorm -> Attention."""

    def __init__(self, dim, heads, dim_head, dropout=0., generator=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout,
                              generator=generator)

    def forward(self, x):
        return self.attn(self.norm(x))


class PreNormFeedForward(nn.Module):
    """LayerNorm -> FeedForward."""

    def __init__(self, dim, hidden_dim, dropout=0., generator=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, hidden_dim, dropout=dropout, generator=generator)

    def forward(self, x):
        return self.ff(self.norm(x))


class Transformer(nn.Module):
    """Pre-norm transformer: ``depth`` x (``attn_{i}`` + residual,
    ``ff_{i}`` + residual), then a final LayerNorm."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim, dropout=0.,
                 generator=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module("attn_{}".format(i), PreNormAttention(
                dim, heads, dim_head, dropout=dropout, generator=generator))
            self.add_module("ff_{}".format(i), PreNormFeedForward(
                dim, mlp_dim, dropout=dropout, generator=generator))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, "attn_{}".format(i))(x) + x
            x = getattr(self, "ff_{}".format(i))(x) + x
        return self.norm(x)
