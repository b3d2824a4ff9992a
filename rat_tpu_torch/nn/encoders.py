"""RAT_m2 encoder over the (1+K) x (F+1) token grid (port of
rat_tpu.nn.encoders.CrossIntraEncoder and CrossIntraEncoderBlock).

Each block: intra-sample attention over the F+1 feature tokens,
cross-sample attention over the 1+K samples, then a feed-forward, each
with a residual; the FF has NO pre-norm, as in the reference. The JAX
package's ``stream`` and ``grid_minor`` implementations are TPU layout
schedules of this one math, written here once.
"""

from torch import nn

from .layers import FeedForward, PreNormAttention


class CrossIntraEncoderBlock(nn.Module):
    def __init__(self, dim, num_heads, head_dim, hidden_dim, generator=None):
        super().__init__()
        self.intra_attention = PreNormAttention(dim, num_heads, head_dim, generator)
        self.cross_attention = PreNormAttention(dim, num_heads, head_dim, generator)
        self.mlp = FeedForward(dim, hidden_dim, generator)

    def forward(self, x):
        b, t, s, d = x.shape
        h = x.reshape(b * t, s, d)
        h = self.intra_attention(h) + h
        h = h.reshape(b, t, s, d).transpose(1, 2).reshape(b * s, t, d)
        h = self.cross_attention(h) + h
        h = self.mlp(h) + h
        return h.reshape(b, s, t, d).transpose(1, 2)


class CrossIntraEncoder(nn.Module):
    def __init__(self, dim, num_heads, head_dim, depth, hidden_dim,
                 generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            CrossIntraEncoderBlock(dim, num_heads, head_dim, hidden_dim, generator)
            for _ in range(depth))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x
