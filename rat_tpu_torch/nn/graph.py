"""Graph CTR layers (port of rat_tpu.nn.graph):

- FiGNN_Layer / GraphLayer: the fully connected field graph with an
  attention adjacency, per-field in/out projections and an optional GRU
  cell; the field graph is a dense [F, F] adjacency, so message passing
  is a batched matmul;
- HypergraphLayer / PET_Layer: PET's hypergraph message passing over an
  edge list (``data.graph.batch_graphs``), with the softmax of the edge
  scores taken per destination node (:func:`edge_softmax`).

Rows are gathered with ``index_select``, whose backward is one
``index_add``; the backward of advanced indexing sorts the indices on a
card.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import xavier_normal
from .layers import Dropout, linear


class GraphLayer(nn.Module):
    """Per-field out projection, aggregation over the adjacency g
    [B, F, F], per-field in projection, plus ``bias_p``. ``W_in`` and
    ``W_out`` are [F, d, d] einsum weights, applied as
    ``"fde,bfe->bfd"``."""

    def __init__(self, num_fields, embedding_dim, generator=None):
        super().__init__()
        shape = (num_fields, embedding_dim, embedding_dim)
        self.W_in = nn.Parameter(xavier_normal(generator, shape))
        self.W_out = nn.Parameter(xavier_normal(generator, shape))
        self.bias_p = nn.Parameter(torch.zeros(embedding_dim))

    def forward(self, g, h):
        h_out = torch.einsum("fde,bfe->bfd", self.W_out, h)
        aggr = torch.bmm(g, h_out)
        return torch.einsum("fde,bfe->bfd", self.W_in, aggr) + self.bias_p


class GRUCell(nn.Module):
    """``torch.nn.GRUCell``'s math with the gates split (r, z, n) and a
    bias on both ``ih`` and ``hh``: n = tanh(x_n + r h_n)."""

    def __init__(self, input_dim, hidden_dim, generator=None):
        super().__init__()
        self.ih = linear(input_dim, 3 * hidden_dim, generator)
        self.hh = linear(hidden_dim, 3 * hidden_dim, generator)

    def forward(self, x, h):
        xr, xz, xn = self.ih(x).chunk(3, dim=-1)
        hr, hz, hn = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h


class FiGNN_Layer(nn.Module):
    """FiGNN over [B, F, d] field embeddings: edge weights from
    ``W_attn`` over each (source, destination) pair's concatenated
    embeddings, leaky relu (slope 0.01), no self-loops (the diagonal is
    -inf before the softmax); then ``gnn_layers`` steps of GraphLayer
    (one shared ``gnn``, or ``gnn_{i}``), each followed by the GRU cell
    ``gru`` or a residual add, plus the input when ``use_residual``."""

    def __init__(self, num_fields, embedding_dim, gnn_layers=3, reuse_graph_layer=False,
                 use_gru=True, use_residual=True, generator=None):
        super().__init__()
        self.num_fields, self.embedding_dim = num_fields, embedding_dim
        self.gnn_layers, self.use_residual = gnn_layers, use_residual
        self.W_attn = linear(2 * embedding_dim, 1, generator, bias=False)
        self.reuse_graph_layer = reuse_graph_layer
        for name in ["gnn"] if reuse_graph_layer else \
                ["gnn_{}".format(i) for i in range(gnn_layers)]:
            self.add_module(name, GraphLayer(num_fields, embedding_dim, generator))
        self.gru = GRUCell(embedding_dim, embedding_dim, generator) if use_gru else None
        src, dst = torch.meshgrid(torch.arange(num_fields), torch.arange(num_fields),
                                  indexing="ij")
        self.register_buffer("src", src.reshape(-1), persistent=False)
        self.register_buffer("dst", dst.reshape(-1), persistent=False)
        self.register_buffer("eye", torch.eye(num_fields, dtype=torch.bool),
                             persistent=False)

    def forward(self, feature_emb):
        F_, d = self.num_fields, self.embedding_dim
        concat_emb = torch.cat([feature_emb.index_select(1, self.src),
                                feature_emb.index_select(1, self.dst)], dim=-1)
        alpha = F.leaky_relu(self.W_attn(concat_emb), negative_slope=0.01)
        alpha = alpha.reshape(-1, F_, F_).masked_fill(self.eye, -float("inf"))
        g = torch.softmax(alpha, dim=-1)
        h = feature_emb
        for i in range(self.gnn_layers):
            gnn = self.gnn if self.reuse_graph_layer else getattr(self, "gnn_{}".format(i))
            a = gnn(g, h)
            if self.gru is not None:
                h = self.gru(a.reshape(-1, d), h.reshape(-1, d)).reshape(-1, F_, d)
            else:
                h = a + h
            if self.use_residual:
                h = h + feature_emb
        return h


def edge_softmax(scores, dst, num_nodes):
    """Softmax of the edge scores [E, H] over the edges that share a
    destination node, per column (DGL's edge_softmax): the maximum by
    ``scatter_reduce`` and the sum by ``index_add``, as JAX's
    segment_max and segment_sum. CUDA's index_add adds in no fixed
    order."""
    index = dst[:, None].expand_as(scores)
    score_max = scores.new_full((num_nodes, scores.shape[1]), -float("inf")).scatter_reduce(
        0, index, scores, "amax", include_self=False)
    scores = torch.exp(scores - score_max.index_select(0, dst))
    denom = scores.new_zeros((num_nodes, scores.shape[1])).index_add(0, dst, scores)
    return scores / (denom.index_select(0, dst) + 1e-12)


class HypergraphLayer(nn.Module):
    """One PET hypergraph attention step over an edge list: node_h
    [N, in], edge_h [E, in], src / dst [E]. Each edge's message is
    [node_h[src] * edge_h, node_h[src]]; the destination's query ``Q``
    scores the message's key ``K`` per column, the scores are softmaxed
    over each node's incoming edges and weight the values ``V``; ``W``
    maps [sum of messages, node_h] to the new node states and ``edge_W``
    [new src, new dst, edge_h] to the new edge states."""

    def __init__(self, in_feat, hidden_feat, generator=None):
        super().__init__()
        self.Q = linear(in_feat, hidden_feat, generator)
        self.K = linear(2 * in_feat, hidden_feat, generator)
        self.V = linear(2 * in_feat, hidden_feat, generator)
        self.W = linear(hidden_feat + in_feat, hidden_feat, generator)
        self.edge_W = linear(2 * hidden_feat + in_feat, hidden_feat, generator)

    def forward(self, node_h, edge_h, src, dst):
        num_nodes = node_h.shape[0]
        src_h = node_h.index_select(0, src)
        src_messages = torch.cat([src_h * edge_h, src_h], dim=1)
        alpha = edge_softmax(self.Q(node_h).index_select(0, dst) * self.K(src_messages),
                             dst, num_nodes)
        V = alpha * self.V(src_messages)
        h_n = V.new_zeros((num_nodes, V.shape[1])).index_add(0, dst, V)
        new_node_h = self.W(torch.cat([h_n, node_h], dim=1))
        new_edge_h = self.edge_W(torch.cat([new_node_h.index_select(0, src),
                                       new_node_h.index_select(0, dst), edge_h], dim=1))
        return new_node_h, new_edge_h


class PET_Layer(nn.Module):
    """``num_layers`` hypergraph steps (``layer_{i}``), each followed by
    relu, the shared LayerNorm ``layernorm`` and dropout, on the node and
    the edge states alike."""

    def __init__(self, num_layers, in_feat, hidden_feat, dropout=0.1, generator=None):
        super().__init__()
        for i in range(num_layers):
            self.add_module("layer_{}".format(i), HypergraphLayer(
                in_feat if i == 0 else hidden_feat, hidden_feat, generator))
        self.num_layers = num_layers
        self.layernorm = nn.LayerNorm(hidden_feat, eps=1e-5)
        self.drop = Dropout(dropout)

    def forward(self, node_h, edge_h, src, dst):
        for i in range(self.num_layers):
            node_h, edge_h = getattr(self, "layer_{}".format(i))(node_h, edge_h, src, dst)
            node_h = self.drop(self.layernorm(torch.relu(node_h)))
            edge_h = self.drop(self.layernorm(torch.relu(edge_h)))
        return node_h, edge_h
