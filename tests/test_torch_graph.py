"""The port's graph layers (rat_tpu_torch.nn.graph), PET graph
preprocessing (rat_tpu_torch.data.graph) and MergedEmbeddingLayer
against the JAX package's on seeded inputs on the CPU: the instance
graphs and their batch array for array (values and dtypes); the edge
softmax, GraphLayer, the GRU cell, FiGNN in each of its options,
HypergraphLayer and PET_Layer over a batch of 5 graphs (F=4 fields,
1+K=3 rows, d=6). Outputs within rtol 1e-5 / atol 1e-6, gradients
within rtol 1e-4 / atol 1e-5, the layers' atol at the scale of the
largest value where it is above 1 (torch_layer_parity.compare)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.data import graph as jdg
from rat_tpu.features import FeatureMap
from rat_tpu.nn import embedding as jemb
from rat_tpu.nn import graph as jg
from rat_tpu_torch.data import graph as tdg
from rat_tpu_torch.nn import embedding as temb
from rat_tpu_torch.nn import graph as tg
from torch_layer_parity import compare, one_thread  # noqa: F401

F, T, D = 4, 3, 6
VOCAB = {"a": 5, "b": 3, "c": 7, "d": 4}


def _feature_map():
    fm = FeatureMap("t", ".")
    for i, (name, size) in enumerate(VOCAB.items()):
        fm.feature_specs[name] = {"source": "", "type": "categorical", "vocab_size": size,
                                  "index": i}
    fm.num_fields = fm.input_length = len(VOCAB)
    return fm


def _grids(seed, n=5):
    """n groups of 1+K rows; ids drawn from few values, so rows share
    feature nodes."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.randint(0, size, (n, T)) for size in VOCAB.values()], axis=-1)
    y = rng.randint(0, 2, (n, T)).astype(np.float32)
    return X.astype(np.int64), y


def test_convert_indices_and_graphs_equal_jax():
    fm = _feature_map()
    X, y = _grids(0)
    jX = jdg.PETGraphProcessor.convert_indices(X, fm.feature_specs)
    tX = tdg.PETGraphProcessor.convert_indices(X, fm.feature_specs)
    np.testing.assert_array_equal(tX, jX)
    cases = [(tX[i], y[i]) for i in range(len(tX))] + [(tX[0, 0], y[0, 0])]  # + a lone row
    jgraphs = [jdg.PETGraphProcessor.build_instance_graph(a, b) for a, b in cases]
    tgraphs = [tdg.PETGraphProcessor.build_instance_graph(a, b) for a, b in cases]
    for want, got in zip(jgraphs + [jdg.batch_graphs(jgraphs)],
                         tgraphs + [tdg.batch_graphs(tgraphs)]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
    g = tgraphs[0]
    assert g["label"][0] == 2 and (g["label"][T:] == 2).all()


def _batch(seed):
    fm = _feature_map()
    X, y = _grids(seed)
    X = tdg.PETGraphProcessor.convert_indices(X, fm.feature_specs)
    return tdg.batch_graphs([tdg.PETGraphProcessor.build_instance_graph(a, b)
                             for a, b in zip(X, y)])


def test_edge_softmax():
    b = _batch(1)
    N, E = b["num_nodes"], len(b["edge_dst"])
    scores = np.random.RandomState(2).randn(E, 3).astype(np.float32) * 3
    g = np.random.RandomState(3).randn(E, 3).astype(np.float32)
    jout, vjp = jax.vjp(lambda s: jg._edge_softmax(s, jnp.asarray(b["edge_dst"]), N),
                        jnp.asarray(scores))
    st = torch.from_numpy(scores).requires_grad_()
    out = tg.edge_softmax(st, torch.from_numpy(b["edge_dst"].astype(np.int64)), N)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-5)


def _emb(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_graph_layer_and_gru_cell():
    g = jax.nn.softmax(jnp.asarray(_emb(4, 5, F, F)), axis=-1)
    compare(jg.GraphLayer(F, D), tg.GraphLayer(F, D), [np.asarray(g), _emb(5, 5, F, D)],
            grads=True)
    compare(jg.GRUCell(D), tg.GRUCell(D, D), [_emb(6, 7, D), _emb(7, 7, D)], grads=True)


@pytest.mark.parametrize("reuse,gru,residual", [
    (False, True, True), (True, True, False), (False, False, True), (True, False, False)])
def test_fignn_layer(reuse, gru, residual):
    kw = dict(gnn_layers=3, reuse_graph_layer=reuse, use_gru=gru, use_residual=residual)
    compare(jg.FiGNN_Layer(F, D, **kw), tg.FiGNN_Layer(F, D, **kw), [_emb(8, 5, F, D)],
            grads=True)


def _graph_inputs(seed, d=D):
    b = _batch(seed)
    N, E = b["num_nodes"], len(b["edge_src"])
    return [_emb(seed + 10, N, d), _emb(seed + 11, E, d), b["edge_src"], b["edge_dst"]]


def test_hypergraph_layer():
    compare(jg.HypergraphLayer(D, 5), tg.HypergraphLayer(D, 5), _graph_inputs(12),
            grads=True)


@pytest.mark.parametrize("layers", [1, 2])
def test_pet_layer(layers):
    """Eval mode (dropout off); the shared LayerNorm ``layernorm``."""
    compare(jg.PET_Layer(layers, D, 5, dropout=0.1), tg.PET_Layer(layers, D, 5, dropout=0.1),
            _graph_inputs(13), train=False, grads=True)


def test_merged_embedding_layer():
    """The lookup of globally offset ids against JAX's, and the init's
    distribution: U(-a, a), a = sqrt(6 / (rows + d)) (flax's
    variance_scaling(1, fan_avg, uniform); the generators differ)."""
    fm = _feature_map()
    X, _ = _grids(14)
    X = tdg.PETGraphProcessor.convert_indices(X, fm.feature_specs)
    compare(jemb.MergedEmbeddingLayer(fm, D), temb.MergedEmbeddingLayer(fm, D), [X],
            grads=True)
    big = FeatureMap("t", ".")
    big.feature_specs = {"x": {"type": "categorical", "vocab_size": 20000, "index": 0}}
    table = temb.MergedEmbeddingLayer(big, 40, torch.Generator().manual_seed(0)).table.detach()
    bound = np.sqrt(6.0 / (20000 + 40))
    assert table.shape == (20000, 40)
    assert float(table.abs().max()) <= bound and float(table.abs().max()) > 0.99 * bound
    np.testing.assert_allclose(float(table.var()), bound ** 2 / 3, rtol=0.01)
    np.testing.assert_allclose(float(table.mean()), 0.0, atol=1e-3 * bound)
