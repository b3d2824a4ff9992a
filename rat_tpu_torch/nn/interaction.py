"""Feature-interaction layer library (port of rat_tpu.nn.interaction):
inner products, FiBiNET's bilinear and holographic (FFT) interactions,
DCN's cross network, xDeepFM's CIN and the InteractionMachine. Library
components for any CTR head; the RAT variants use only the product-sum
pooling, through FMLayer.

Field pairs run in ``itertools.combinations`` order, their indices held
as buffers that move with the module. Pairs are gathered with
``index_select``, whose backward is one ``index_add``; the backward of
advanced indexing sorts the indices on a card.
"""

from itertools import combinations

import torch
from torch import nn

from .initializers import xavier_normal
from .layers import TorchBatchNorm, bi_interaction, linear


def _register_pairs(module, num_fields):
    """Give ``module`` the (i, j) field pairs, i < j, as index buffers
    ``p`` and ``q``; returns their count."""
    p, q = zip(*combinations(range(num_fields), 2))
    module.register_buffer("p", torch.tensor(p), persistent=False)
    module.register_buffer("q", torch.tensor(q), persistent=False)
    return len(p)


class InnerProductLayer(nn.Module):
    """Pairwise inner products of [B, F, d] embeddings. ``output``:
    product_sum_pooling [B, 1], Bi_interaction_pooling [B, d],
    elementwise_product [B, P, d] or inner_product [B, P] (the last two
    need ``num_fields``)."""

    OUTPUTS = ("product_sum_pooling", "Bi_interaction_pooling", "elementwise_product",
               "inner_product")

    def __init__(self, num_fields=None, output="product_sum_pooling"):
        super().__init__()
        if output not in self.OUTPUTS:
            raise ValueError("output={} is not supported.".format(output))
        if output in self.OUTPUTS[2:]:
            assert num_fields is not None
            _register_pairs(self, num_fields)
        self.output = output

    def forward(self, feature_emb):
        if self.output == "Bi_interaction_pooling":
            return bi_interaction(feature_emb)
        if self.output == "product_sum_pooling":
            return bi_interaction(feature_emb).sum(dim=-1, keepdim=True)
        product = feature_emb.index_select(1, self.p) * feature_emb.index_select(1, self.q)
        return product if self.output == "elementwise_product" else product.sum(dim=-1)


class BilinearInteractionLayer(nn.Module):
    """FiBiNET's bilinear interactions (emb_i W) * emb_j over the field
    pairs, [B, P, d]. ``bilinear_type``: one W for all fields
    (field_all, [d, d]), one per field (field_each, [F d, d]) or one per
    pair (field_interaction, [P d, d])."""

    def __init__(self, num_fields, embedding_dim, bilinear_type="field_interaction",
                 generator=None):
        super().__init__()
        rows = {"field_all": 1, "field_each": num_fields,
                "field_interaction": _register_pairs(self, num_fields)}
        if bilinear_type not in rows:
            raise NotImplementedError(bilinear_type)
        self.bilinear_type = bilinear_type
        self.d = embedding_dim
        self.W = nn.Parameter(xavier_normal(
            generator, (rows[bilinear_type] * embedding_dim, embedding_dim)))

    def forward(self, feature_emb):
        d = self.d
        if self.bilinear_type == "field_all":
            left = torch.einsum("bfd,de->bfe", feature_emb, self.W).index_select(1, self.p)
        elif self.bilinear_type == "field_each":
            left = torch.einsum("bfd,fde->bfe", feature_emb,
                                self.W.reshape(-1, d, d)).index_select(1, self.p)
        else:
            left = torch.einsum("bpd,pde->bpe", feature_emb.index_select(1, self.p),
                                self.W.reshape(-1, d, d))
        return left * feature_emb.index_select(1, self.q)


class HolographicInteractionLayer(nn.Module):
    """Holographic interactions of the field pairs, [B, P, d]:
    hadamard_product, or circular_convolution / circular_correlation
    through the real FFT of length d."""

    TYPES = ("hadamard_product", "circular_convolution", "circular_correlation")

    def __init__(self, num_fields, interaction_type="circular_convolution"):
        super().__init__()
        if interaction_type not in self.TYPES:
            raise ValueError("interaction_type={} is not supported."
                             .format(interaction_type))
        _register_pairs(self, num_fields)
        self.interaction_type = interaction_type

    def forward(self, feature_emb):
        emb1, emb2 = feature_emb.index_select(1, self.p), feature_emb.index_select(1, self.q)
        if self.interaction_type == "hadamard_product":
            return emb1 * emb2
        f1 = torch.fft.rfft(emb1)
        if self.interaction_type == "circular_correlation":
            f1 = torch.conj(f1)
        return torch.fft.irfft(f1 * torch.fft.rfft(emb2), n=emb1.shape[-1])


class CrossInteractionLayer(nn.Module):
    """One DCN cross step: x0 * (x_i . w) + b, w [input_dim, 1]."""

    def __init__(self, input_dim, generator=None):
        super().__init__()
        self.weight = nn.Parameter(xavier_normal(generator, (input_dim, 1)))
        self.bias = nn.Parameter(torch.zeros(input_dim))

    def forward(self, X_0, X_i):
        return X_0 * (X_i @ self.weight) + self.bias


class CrossNet(nn.Module):
    """DCN's cross network: ``num_layers`` residual cross steps."""

    def __init__(self, input_dim, num_layers, generator=None):
        super().__init__()
        self.cross_layers = nn.ModuleList(CrossInteractionLayer(input_dim, generator)
                                          for _ in range(num_layers))

    def forward(self, X_0):
        X_i = X_0
        for layer in self.cross_layers:
            X_i = X_i + layer(X_0, X_i)
        return X_i


class CompressedInteractionNet(nn.Module):
    """xDeepFM's CIN: layer i mixes the outer (Hadamard) products of its
    input [B, H, d] with the fields [B, F, d] by ``cin_w{i}`` [H F,
    units] (a 1x1 convolution), and sum-pools each layer over d; ``fc``
    maps the pooled layers to ``output_dim``."""

    def __init__(self, num_fields, cin_layer_units, output_dim=1, generator=None):
        super().__init__()
        self.n_layers = len(cin_layer_units)
        H = num_fields
        for i, units in enumerate(cin_layer_units):
            self.register_parameter("cin_w{}".format(i), nn.Parameter(
                xavier_normal(generator, (H * num_fields, units))))
            H = units
        self.fc = linear(sum(cin_layer_units), output_dim, generator)

    def forward(self, feature_emb):
        X_0 = X_i = feature_emb
        pooling_outputs = []
        for i in range(self.n_layers):
            B, H, d = X_i.shape
            hadamard = torch.einsum("bhd,bmd->bhmd", X_i, X_0).reshape(B, -1, d)
            X_i = torch.einsum("bnd,nu->bud", hadamard, getattr(self, "cin_w{}".format(i)))
            pooling_outputs.append(X_i.sum(dim=-1))
        return self.fc(torch.cat(pooling_outputs, dim=-1))


def _ipow(x, n):
    """x ** n by square-and-multiply, the products JAX's integer_pow
    forms, so that the power sums round alike."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


class InteractionMachine(nn.Module):
    """The InteractionMachine's interactions of orders 1 to ``order`` (at
    most 5) from the power sums over the fields, [B, order d],
    optionally batch-normalized, then one Linear to [B, 1]."""

    def __init__(self, embedding_dim, order=2, batch_norm=False, generator=None):
        super().__init__()
        assert 1 <= order <= 5, "order={} is not supported.".format(order)
        self.order = order
        self.norms = nn.ModuleList([TorchBatchNorm(order * embedding_dim)]) \
            if batch_norm else None
        self.linears = nn.ModuleList([linear(order * embedding_dim, 1, generator)])

    def forward(self, feature_emb):
        p = {k: _ipow(feature_emb, k).sum(dim=1) for k in range(1, self.order + 1)}
        p1 = p[1]
        out = [p1]
        if self.order >= 2:
            out.append((_ipow(p1, 2) - p[2]) / 2)
        if self.order >= 3:
            out.append((_ipow(p1, 3) - 3 * p1 * p[2] + 2 * p[3]) / 6)
        if self.order >= 4:
            out.append((_ipow(p1, 4) - 6 * _ipow(p1, 2) * p[2] + 3 * _ipow(p[2], 2)
                        + 8 * p1 * p[3] - 6 * p[4]) / 24)
        if self.order == 5:
            out.append((_ipow(p1, 5) - 10 * _ipow(p1, 3) * p[2] + 20 * _ipow(p1, 2) * p[3]
                        - 30 * p1 * p[4] - 20 * p[2] * p[3] + 15 * p1 * _ipow(p[2], 2)
                        + 24 * p[5]) / 120)
        y = torch.cat(out, dim=-1)
        if self.norms is not None:
            y = self.norms[0](y)
        return self.linears[0](y)
