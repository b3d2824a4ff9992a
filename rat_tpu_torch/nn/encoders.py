"""RAT encoder stacks over the (1+K) x (F+1) token grid (port of
rat_tpu.nn.encoders):

- CrossIntraEncoder (RAT_m2, the default): each block runs intra-sample
  attention over the F+1 feature tokens, cross-sample attention over
  the 1+K samples, then a feed-forward, each with a residual; the FF has
  NO pre-norm, as in the reference.
- CrossIntraEncoderPA (RAT_m3): parallel intra and cross attention with
  one shared query projection, each branch with its own K, V and output
  projection and HALF the heads (``num_heads // 2`` heads of width
  inner / (num_heads // 2), still scaled by ``head_dim ** -0.5``); the
  branch outputs are averaged, and the only residual is around the FF,
  back to the block input.
- JointEncoder (RAT_m0): the grid flattened to one sequence of t*s
  tokens through one pre-norm Transformer.
- CascadeEncoder (RAT_m1): an intra Transformer over each sample's s
  tokens, each sample's CLS, then a cross Transformer over the 1+K CLS
  tokens; it returns [b, 1+K, d].

``p_dropout`` / ``dropout`` drop after the attention output projections
(and, in the Transformers, inside the feed-forwards). The JAX package's
``stream`` and ``grid_minor`` implementations are TPU layout schedules
of this one math, written here once.
"""

import torch.nn.functional as F
from torch import nn

from .initializers import xavier_normal
from .layers import (Dropout, FeedForward, PreNormAttention, Transformer, linear,
                     mhsa)


class CrossIntraEncoderBlock(nn.Module):
    def __init__(self, dim, num_heads, head_dim, hidden_dim, p_dropout=0.,
                 generator=None):
        super().__init__()
        self.intra_attention = PreNormAttention(dim, num_heads, head_dim, p_dropout,
                                                generator=generator)
        self.cross_attention = PreNormAttention(dim, num_heads, head_dim, p_dropout,
                                                generator=generator)
        self.mlp = FeedForward(dim, hidden_dim, generator=generator)

    def forward(self, x):
        b, t, s, d = x.shape
        h = x.reshape(b * t, s, d)
        h = self.intra_attention(h) + h
        h = h.reshape(b, t, s, d).transpose(1, 2).reshape(b * s, t, d)
        h = self.cross_attention(h) + h
        h = self.mlp(h) + h
        return h.reshape(b, s, t, d).transpose(1, 2)


class CrossIntraEncoder(nn.Module):
    def __init__(self, dim, num_heads, head_dim, depth, hidden_dim, p_dropout=0.,
                 generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            CrossIntraEncoderBlock(dim, num_heads, head_dim, hidden_dim, p_dropout,
                                   generator=generator)
            for _ in range(depth))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class SharedQAttention(nn.Module):
    """One RAT_m3 branch: LayerNorm, the block's shared query projection
    and the branch's own K and V, attention in num_heads // 2 heads
    scaled by ``head_dim ** -0.5`` (the reference's quirk), output
    projection and dropout. (The JAX module skips the projection when
    num_heads == 1 and head_dim == dim; RAT_m3 needs 2 heads or more,
    so it always projects.)"""

    def __init__(self, dim, num_heads, head_dim, dropout=0., generator=None):
        super().__init__()
        inner = num_heads * head_dim
        self.heads = num_heads // 2
        self.scale = head_dim ** -0.5
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.W_k = linear(dim, inner, generator, bias=False)
        self.W_v = linear(dim, inner, generator, bias=False)
        self.to_out = linear(inner, dim, generator)
        self.drop = Dropout(dropout)

    def forward(self, x, w_q):
        x = self.norm(x)
        out = mhsa(F.linear(x, w_q), self.W_k(x), self.W_v(x), self.heads, self.scale)
        return self.drop(self.to_out(out))


class CrossIntraEncoderBlockPA(nn.Module):
    def __init__(self, dim, num_heads, head_dim, hidden_dim, p_dropout=0.,
                 generator=None):
        super().__init__()
        if num_heads < 2:
            raise ValueError("RAT_m3 halves the head count per branch: "
                             "num_heads must be at least 2")
        # the shared query projection, in nn.Linear layout [inner, dim]
        self.W_q = nn.Parameter(xavier_normal(generator, (num_heads * head_dim, dim)))
        self.intra_attention = SharedQAttention(dim, num_heads, head_dim, p_dropout,
                                                generator=generator)
        self.cross_attention = SharedQAttention(dim, num_heads, head_dim, p_dropout,
                                                generator=generator)
        self.mlp = FeedForward(dim, hidden_dim, generator=generator)

    def forward(self, x):
        b, t, s, d = x.shape
        out_s = self.intra_attention(x.reshape(b * t, s, d), self.W_q).reshape(b, t, s, d)
        out_t = self.cross_attention(x.transpose(1, 2).reshape(b * s, t, d),
                                     self.W_q).reshape(b, s, t, d).transpose(1, 2)
        return self.mlp((out_s + out_t) / 2.0) + x


class CrossIntraEncoderPA(nn.Module):
    def __init__(self, dim, num_heads, head_dim, depth, hidden_dim, p_dropout=0.,
                 generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            CrossIntraEncoderBlockPA(dim, num_heads, head_dim, hidden_dim, p_dropout,
                                     generator=generator)
            for _ in range(depth))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class JointEncoder(nn.Module):
    def __init__(self, dim, depth, num_heads, head_dim, mlp_dim, dropout=0.,
                 generator=None):
        super().__init__()
        self.encoder = Transformer(dim, depth, num_heads, head_dim, mlp_dim, dropout,
                                   generator=generator)

    def forward(self, x):
        b, t, s, d = x.shape
        return self.encoder(x.reshape(b, t * s, d)).reshape(b, t, s, d)


class CascadeEncoder(nn.Module):
    def __init__(self, dim, depth, num_heads, head_dim, mlp_dim, dropout=0.,
                 generator=None):
        super().__init__()
        self.intra_transformer = Transformer(dim, depth, num_heads, head_dim, mlp_dim,
                                             dropout, generator=generator)
        self.cross_transformer = Transformer(dim, depth, num_heads, head_dim, mlp_dim,
                                             dropout, generator=generator)

    def forward(self, x):
        b, t, s, d = x.shape
        h = self.intra_transformer(x.reshape(b * t, s, d))
        return self.cross_transformer(h[:, 0].reshape(b, t, d))      # [b, 1+K, d]
