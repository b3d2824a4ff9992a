"""Core NN layers (port of rat_tpu.nn.layers): BatchNorm, dropout, MLP
tower, LR (wide) tower, FM, transformer primitives.

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

Under a mesh each data rank holds a contiguous slice of the global
batch. Dropout then draws the GLOBAL batch's mask from the generator,
which every rank seeds alike, and keeps its own rows: the masks are one
device's, bit for bit. BatchNorm (:func:`set_batch_norm_group`) takes
its batch statistics over the data group, as the JAX package's batch
mean spans the data axis: the training step, running statistics
included, is the global batch's.
"""

import torch
import torch.distributed as dist
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
        self.batch_slice = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.p >= 1:
            return torch.zeros_like(x)
        shape = x.shape
        if self.batch_slice is not None:
            # the leading axis is batch-major (a batch, or a batch merged
            # with the axes after it): this rank's rows are a contiguous
            # part of the global batch's
            parts, index = self.batch_slice
            shape = (shape[0] * parts,) + tuple(shape[1:])
        keep = torch.rand(shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) < 1 - self.p
        if self.batch_slice is not None:
            keep = keep[index * x.shape[0]: (index + 1) * x.shape[0]]
        return torch.where(keep, x / (1 - self.p), torch.zeros_like(x))


def set_dropout_generator(module, generator, batch_slice=None):
    """Draw every dropout mask under ``module`` from ``generator``; with
    ``batch_slice = (parts, index)`` the input is part ``index`` of a
    batch cut into ``parts`` equal parts, and the mask that part of the
    whole batch's."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.batch_slice = batch_slice


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient of every rank's input is
    the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def set_batch_norm_group(module, group):
    """Take the training batch statistics of every BatchNorm under
    ``module`` over the process ``group`` (equal batch slices)."""
    for m in module.modules():
        if isinstance(m, TorchBatchNorm):
            m.group = group


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis, as the JAX package's
    ``TorchBatchNorm``: in training, normalize with the batch mean and
    BIASED variance, and move the running mean and the UNBIASED running
    variance (factor n / max(n - 1, 1)) by ``momentum`` (torch's
    convention: flax's decay is 1 - momentum, 0.9 for the default 0.1);
    in eval, normalize with the running statistics. ``affine=False``
    drops the scale and bias (Dice's norm). Unlike ``nn.BatchNorm1d`` it
    takes a batch of one row in training, as the JAX module does. The
    running statistics are buffers."""

    def __init__(self, num_features, momentum=0.1, eps=1e-5, affine=True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group = None

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            if self.group is None:
                mean = x.mean(dim=axes)
                var = torch.square(x - mean).mean(dim=axes)
            else:
                n *= dist.get_world_size(self.group)
                mean = _AllReduceSum.apply(x.sum(dim=axes), self.group) / n
                var = _AllReduceSum.apply(torch.square(x - mean).sum(dim=axes),
                                          self.group) / n
            decay = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(decay * self.running_mean
                                        + (1.0 - decay) * mean)
                self.running_var.copy_(decay * self.running_var
                                       + (1.0 - decay) * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y if self.weight is None else y * self.weight + self.bias


def bi_interaction(feature_emb):
    """[..., F, d] -> [..., d]: the sum over field pairs of the
    elementwise products, as (sum^2 - sum of squares) / 2."""
    square_of_sum = feature_emb.sum(dim=-2) ** 2
    sum_of_squares = (feature_emb ** 2).sum(dim=-2)
    return (square_of_sum - sum_of_squares) * 0.5


def _per_layer(value, n):
    """One value per hidden layer: a list as given, else ``value`` n times."""
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class MLPLayer(nn.Module):
    """Dense tower: [Linear, BatchNorm?, act, dropout]* + an output
    Linear when ``output_dim`` is set, then ``output_activation``.
    ``hidden_activations`` and ``dropout_rates`` are one value or one
    per hidden layer."""

    def __init__(self, input_dim, output_dim=None, hidden_units=(),
                 hidden_activations="relu", dropout_rates=0., batch_norm=False,
                 generator=None, output_activation=None, use_bias=True):
        super().__init__()
        self.acts = [get_activation(a) for a in
                     _per_layer(hidden_activations, len(hidden_units))]
        self.out_act = None if output_activation is None \
            else get_activation(output_activation)
        dims = [input_dim] + list(hidden_units) \
            + ([] if output_dim is None else [output_dim])
        self.n_hidden = len(hidden_units)
        self.linears = nn.ModuleList(linear(a, b, generator, bias=use_bias)
                                     for a, b in zip(dims, dims[1:]))
        self.norms = nn.ModuleList(TorchBatchNorm(u) for u in hidden_units) \
            if batch_norm else None
        self.drops = nn.ModuleList(Dropout(p) for p in
                                   _per_layer(dropout_rates, len(hidden_units)))

    def forward(self, x):
        for i, layer in enumerate(self.linears):
            x = layer(x)
            if i < self.n_hidden:
                if self.norms is not None:
                    x = self.norms[i](x)
                x = self.drops[i](self.acts[i](x))
        return x if self.out_act is None else self.out_act(x)


class LRLayer(nn.Module):
    """Wide/LR tower via the 1-dim-embedding one-hot trick. For a grid
    input [B, 1+K, F] the per-sample logits are aggregated over the
    samples by ``retrieval_aggregation`` (mean or sum). Bias-free by
    default, as RATModel uses it."""

    def __init__(self, spec, generator=None, use_bias=False,
                 retrieval_aggregation="mean"):
        super().__init__()
        if retrieval_aggregation not in ("mean", "sum"):
            raise NotImplementedError(retrieval_aggregation)
        self.retrieval_aggregation = retrieval_aggregation
        self.embedding_layer = PackedEmbedding(spec, 1, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1)) if use_bias else None

    def forward(self, X_tokens, X_numeric=None):
        output = self.embedding_layer(X_tokens, X_numeric).sum(dim=-2)   # [..., 1]
        if X_tokens.dim() == 3:
            output = output.mean(dim=1) if self.retrieval_aggregation == "mean" \
                else output.sum(dim=1)
        return output if self.bias is None else output + self.bias


class FMLayer(nn.Module):
    """Factorization machine: the LR term (``lr_layer``, with a bias by
    default) plus the pairwise inner products' sum of ``feature_emb``
    [B, F, d]."""

    def __init__(self, spec, use_bias=True, lr_retrieval_aggregation="mean",
                 generator=None):
        super().__init__()
        self.lr_layer = LRLayer(spec, generator=generator, use_bias=use_bias,
                                retrieval_aggregation=lr_retrieval_aggregation)

    def forward(self, X_tokens, feature_emb, X_numeric=None):
        dot_sum = bi_interaction(feature_emb).sum(dim=-1, keepdim=True)
        return dot_sum + self.lr_layer(X_tokens, X_numeric)


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


class PreNorm(nn.Module):
    """LayerNorm over the last axis (``norms.0``, flax's ``LayerNorm_0``),
    then the module ``fn``."""

    def __init__(self, dim, fn):
        super().__init__()
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5)])
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norms[0](x), **kwargs)


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
