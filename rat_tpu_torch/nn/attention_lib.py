"""Attention, activation and sequence-pooling library components (port
of rat_tpu.nn.attention_lib):

- scaled_dot_product_attention, SqueezeExcitationLayer;
- the Dice activation;
- DIN_Attention and MultiHeadTargetAttention (target attention);
- k_max_pooling.

Library components: any CTR head built on the framework may use them;
the RAT variants do not.
"""

import torch
from torch import nn

from .layers import MLPLayer, TorchBatchNorm, linear


def scaled_dot_product_attention(Q, K, V, scale=None, mask=None, dropout=None):
    """(output, attention) of softmax(Q K^T / scale) V. Positions where
    ``mask == 0`` score -1e9; ``dropout`` (a :class:`Dropout`) acts on
    the attention weights."""
    scores = torch.matmul(Q, K.transpose(-1, -2))
    if scale:
        scores = scores / scale
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1.e9)
    attention = torch.softmax(scores, dim=-1)
    if dropout is not None:
        attention = dropout(attention)
    return torch.matmul(attention, V), attention


class SqueezeExcitationLayer(nn.Module):
    """Field reweighting: the mean over each field's embedding, two
    bias-free Linears with relu, times the embeddings."""

    def __init__(self, num_fields, reduction_ratio=3, generator=None):
        super().__init__()
        reduced_size = max(1, int(num_fields / reduction_ratio))
        self.linears = nn.ModuleList([
            linear(num_fields, reduced_size, generator, bias=False),
            linear(reduced_size, num_fields, generator, bias=False)])

    def forward(self, feature_emb):
        A = torch.relu(self.linears[0](feature_emb.mean(dim=-1)))
        A = torch.relu(self.linears[1](A))
        return feature_emb * A[..., None]


class Dice(nn.Module):
    """Data-adaptive activation: p = sigmoid(BN(X)), p X + (1 - p) alpha X.
    The BatchNorm has no scale or bias, eps 1e-9 and torch momentum 0.01
    (flax decay 0.99)."""

    def __init__(self, input_dim, eps=1e-9):
        super().__init__()
        self.norms = nn.ModuleList([TorchBatchNorm(input_dim, momentum=0.01, eps=eps,
                                                   affine=False)])
        self.alpha = nn.Parameter(torch.zeros(input_dim))

    def forward(self, X):
        p = torch.sigmoid(self.norms[0](X))
        return p * X + (1 - p) * self.alpha * X


class DIN_Attention(nn.Module):
    """DIN's local activation unit: an MLP scores each history item
    against the target from [target, item, target - item, target * item];
    the scores (masked, optionally softmaxed) weight the history sum."""

    def __init__(self, embedding_dim=64, attention_units=(32,), hidden_activations="relu",
                 output_activation=None, dropout_rate=0, batch_norm=False,
                 use_softmax=False, generator=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.use_softmax = use_softmax
        self.mlps = nn.ModuleList([MLPLayer(
            4 * embedding_dim, 1, tuple(attention_units), hidden_activations,
            dropout_rates=dropout_rate, batch_norm=batch_norm, generator=generator,
            output_activation=output_activation)])

    def forward(self, target_item, history_sequence, mask=None):
        seq_len = history_sequence.shape[1]
        target = target_item[:, None, :].expand_as(history_sequence)
        attention_input = torch.cat([target, history_sequence, target - history_sequence,
                                     target * history_sequence], dim=-1)
        w = self.mlps[0](attention_input.reshape(-1, 4 * self.embedding_dim))
        w = w.reshape(-1, seq_len)
        if mask is not None:
            w = w * mask.to(w.dtype)
        if self.use_softmax:
            if mask is not None:
                w = w + -1.e9 * (1 - mask.to(w.dtype))
            w = torch.softmax(w, dim=-1)
        return (w[..., None] * history_sequence).sum(dim=1)


class MultiHeadTargetAttention(nn.Module):
    """The target item attends over the history in ``num_heads`` heads,
    through bias-free projections W_q, W_k, W_v and W_o (``use_qkvo``);
    masked positions score -1e9, and ``use_scale`` divides the scores by
    head_dim ** 0.5. ``dropout_rate`` is accepted and not applied, as in
    the JAX module."""

    def __init__(self, input_dim=64, attention_dim=64, num_heads=1, dropout_rate=0,
                 use_scale=True, use_qkvo=True, generator=None):
        super().__init__()
        self.attention_dim = attention_dim if use_qkvo else input_dim
        assert self.attention_dim % num_heads == 0
        self.num_heads = num_heads
        self.head_dim = self.attention_dim // num_heads
        self.scale = self.head_dim ** 0.5 if use_scale else None
        self.use_qkvo = use_qkvo
        if use_qkvo:
            for name in ("W_q", "W_k", "W_v"):
                self.add_module(name, linear(input_dim, attention_dim, generator,
                                             bias=False))
            self.W_o = linear(attention_dim, input_dim, generator, bias=False)

    def forward(self, target_item, history_sequence, mask=None):
        if self.use_qkvo:
            query = self.W_q(target_item)
            key, value = self.W_k(history_sequence), self.W_v(history_sequence)
        else:
            query, key, value = target_item, history_sequence, history_sequence
        B = query.shape[0]

        def heads(t):
            return t.reshape(B, -1, self.num_heads, self.head_dim).transpose(1, 2)

        if mask is not None:
            mask = mask.reshape(B, 1, 1, -1)        # over heads and the query
        out, _ = scaled_dot_product_attention(heads(query), heads(key), heads(value),
                                              scale=self.scale, mask=mask)
        out = out.transpose(1, 2).reshape(-1, self.attention_dim)
        return self.W_o(out) if self.use_qkvo else out


_KEY_TYPES = {torch.float32: (torch.int32, 0x7FFFFFFF),
              torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def _total_order_key(x):
    """Integer keys of float values that order as ``jax.lax.top_k``
    orders them: as the floats, with -0.0 below +0.0. Padding rows embed
    to zeros of either sign (``x * 0``), so the two zeros meet often."""
    if x.dtype not in _KEY_TYPES:
        raise TypeError("k_max_pooling takes float32 or float64, not {}".format(x.dtype))
    int_type, magnitude = _KEY_TYPES[x.dtype]
    bits = x.detach().view(int_type)
    return torch.where(bits < 0, bits ^ magnitude, bits)


def k_max_pooling(X, k, dim):
    """The k largest values along ``dim``, kept in their original order.
    Ties go to the lower index, as ``jax.lax.top_k`` breaks them (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    Xm = X.movedim(dim, -1)
    order = torch.sort(_total_order_key(Xm), dim=-1, descending=True,
                       stable=True).indices[..., :k]
    index = torch.sort(order, dim=-1).values
    return torch.gather(Xm, -1, index).movedim(-1, dim)

