"""The port's interaction layers (rat_tpu_torch.nn.interaction) and
FMLayer against the JAX package's on seeded inputs on the CPU (B=6,
F=4, d=5 unless stated): every output mode, bilinear and holographic
type, CrossNet, CIN and the InteractionMachine at each order with and
without BatchNorm, FMLayer on a row and on a retrieval grid. Outputs
within rtol 1e-5 / atol 1e-6; parameter gradients (the FFT's input
gradient) within rtol 1e-4 / atol 1e-5, each atol at the scale of the
largest value where it is above 1 (torch_layer_parity.compare)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.features import FeatureMap
from rat_tpu.nn import embedding as jemb
from rat_tpu.nn import interaction as ji
from rat_tpu.nn import layers as jl
from rat_tpu_torch.nn import embedding as temb
from rat_tpu_torch.nn import interaction as ti
from rat_tpu_torch.nn import layers as tl
from torch_layer_parity import compare, one_thread  # noqa: F401

B, F, D = 6, 4, 5


def _emb(seed=0, d=D, f=F):
    return np.random.RandomState(seed).randn(B, f, d).astype(np.float32)


@pytest.mark.parametrize("output", ["product_sum_pooling", "Bi_interaction_pooling",
                                    "elementwise_product", "inner_product"])
def test_inner_product_layer(output):
    compare(ji.InnerProductLayer(num_fields=F, output=output),
            ti.InnerProductLayer(num_fields=F, output=output), [_emb()])


def test_inner_product_rejects_unknown_output():
    with pytest.raises(ValueError):
        ti.InnerProductLayer(F, output="outer_product")


@pytest.mark.parametrize("kind", ["field_all", "field_each", "field_interaction"])
def test_bilinear_interaction_layer(kind):
    compare(ji.BilinearInteractionLayer(F, D, bilinear_type=kind),
            ti.BilinearInteractionLayer(F, D, bilinear_type=kind), [_emb(1)], grads=True)


@pytest.mark.parametrize("d", [5, 8], ids=["odd_d", "even_d"])
@pytest.mark.parametrize("kind", ["hadamard_product", "circular_convolution",
                                  "circular_correlation"])
def test_holographic_interaction_layer(kind, d):
    """rfft / irfft with n=d (the odd d has no Nyquist bin); the layer
    has no parameter, so the input's gradient through the FFT is held
    against jax.vjp."""
    x = _emb(2, d=d)
    tm = ti.HolographicInteractionLayer(F, kind)
    out = compare(ji.HolographicInteractionLayer(F, kind), tm, [x])
    assert tuple(out.shape) == (B, F * (F - 1) // 2, d)
    g = np.random.RandomState(3).randn(*out.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: ji.HolographicInteractionLayer(F, kind).apply({}, xx),
                     jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tm(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-5)


def test_cross_net():
    x = np.random.RandomState(4).randn(B, 12).astype(np.float32)
    compare(ji.CrossNet(12, 3), ti.CrossNet(12, 3), [x], grads=True)


def test_cross_interaction_layer():
    rng = np.random.RandomState(5)
    x0, xi = rng.randn(B, 7).astype(np.float32), rng.randn(B, 7).astype(np.float32)
    compare(ji.CrossInteractionLayer(7), ti.CrossInteractionLayer(7), [x0, xi])


@pytest.mark.parametrize("units", [(3,), (4, 3)])
def test_compressed_interaction_net(units):
    compare(ji.CompressedInteractionNet(F, units, output_dim=2),
            ti.CompressedInteractionNet(F, units, output_dim=2), [_emb(6)], grads=True)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("batch_norm,train", [(False, False), (True, True), (True, False)],
                         ids=["plain", "bn_train", "bn_eval"])
def test_interaction_machine(order, batch_norm, train):
    """Power sums up to order 5; BatchNorm in train mode (its running
    statistics compared) and eval mode. The JAX gradient is taken
    eagerly, op by op as torch takes it: the order-5 term cancels, and
    XLA's fused gradient differs from JAX's own eager one by up to 6.7e-5
    here, past the tolerance."""
    x = 0.5 * _emb(7)
    compare(ji.InteractionMachine(D, order=order, batch_norm=batch_norm),
            ti.InteractionMachine(D, order=order, batch_norm=batch_norm), [x],
            train=train, grads=True, jit_grad=False)


def _fm_map():
    fm = FeatureMap("t", ".")
    fm.feature_specs.update({
        "u": {"source": "", "type": "categorical", "vocab_size": 9, "index": 0},
        "i": {"source": "", "type": "categorical", "vocab_size": 7, "index": 1,
              "padding_idx": 0},
        "tags": {"source": "", "type": "sequence", "vocab_size": 6, "index": [2, 3, 4],
                 "encoder": "MaskedSumPooling"}})
    fm.num_fields, fm.input_length = 3, 5
    return fm


@pytest.mark.parametrize("grid,aggregation", [(False, "mean"), (True, "mean"),
                                              (True, "sum")])
def test_fm_layer(grid, aggregation):
    """LR term (with its bias) plus product-sum pooling, on a row [B, L]
    or a retrieval grid [B, 1+K, L] whose LR logits are aggregated."""
    fm = _fm_map()
    rng = np.random.RandomState(8)
    shape = (B, 3) if grid else (B,)
    X = np.stack([rng.randint(0, 9, shape), rng.randint(0, 7, shape)]
                 + [rng.randint(0, 6, shape) for _ in range(3)], axis=-1).astype(np.int32)
    emb = _emb(9, f=3)
    jspec = jemb.EmbeddingSpec.build(fm, 1, force_dim=1)
    tspec = temb.EmbeddingSpec.build(fm, 1, force_dim=1)
    out = compare(jl.FMLayer(jspec, lr_retrieval_aggregation=aggregation),
                  tl.FMLayer(tspec, lr_retrieval_aggregation=aggregation), [X, emb],
                  grads=True)
    assert tuple(out.shape) == (B, 1)


def test_fm_layer_keeps_the_embedding_name():
    """The regularizer split keys on "embedding_layer" (engine/optim.py)."""
    spec = temb.EmbeddingSpec.build(_fm_map(), 1, force_dim=1)
    names = sorted(n for n, _ in tl.FMLayer(spec).named_parameters())
    assert names == ["lr_layer.bias", "lr_layer.embedding_layer.table"]
