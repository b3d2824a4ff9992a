"""The port's attention library (rat_tpu_torch.nn.attention_lib) against
the JAX package's on seeded inputs on the CPU (B=6, L=4, d=8 unless
stated): scaled dot-product attention, squeeze-excitation, Dice in train
and eval mode, DIN and multi-head target attention with and without a
mask, and k_max_pooling with ties. Outputs within rtol 1e-5 / atol 1e-6;
k_max_pooling exactly, its input gradient and the layers' parameter
gradients within rtol 1e-4 / atol 1e-5 (in torch_layer_parity.compare
each atol at the scale of the largest value where it is above 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.nn import attention_lib as ja
from rat_tpu_torch.nn import attention_lib as ta
from torch_layer_parity import compare, one_thread  # noqa: F401

B, L, D = 6, 4, 8


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(seed=0):
    m = (np.random.RandomState(seed).rand(B, L) > 0.4).astype(np.float32)
    m[0] = 0.0          # a row with nothing to attend to
    m[1] = 1.0
    return m


@pytest.mark.parametrize("scale,masked", [(None, False), (2.0, False), (2.0, True)])
def test_scaled_dot_product_attention(scale, masked):
    Q, K, V = _x(0, B, 2, 3, D), _x(1, B, 2, L, D), _x(2, B, 2, L, D)
    mask = _mask()[:, None, None, :] if masked else None
    jo, ja_ = ja.scaled_dot_product_attention(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V),
                                              scale=scale, mask=mask)
    to, tattn = ta.scaled_dot_product_attention(
        torch.from_numpy(Q), torch.from_numpy(K), torch.from_numpy(V), scale=scale,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(ja_), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ratio", [3, 1])
def test_squeeze_excitation_layer(ratio):
    compare(ja.SqueezeExcitationLayer(5, reduction_ratio=ratio),
            ta.SqueezeExcitationLayer(5, reduction_ratio=ratio), [_x(3, B, 5, D)],
            grads=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dice(train):
    """Affine-free BatchNorm with eps 1e-9, momentum 0.01: the running
    statistics after a train-mode call are compared too."""
    compare(ja.Dice(D), ta.Dice(D), [_x(4, B, D)], train=train, grads=True)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("use_softmax", [True, False], ids=["softmax", "weights"])
@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_din_attention(masked, use_softmax, batch_norm):
    inputs = [_x(5, B, D), _x(6, B, L, D)] + ([_mask(1)] if masked else [])
    compare(ja.DIN_Attention(D, attention_units=(16, 8), use_softmax=use_softmax,
                             batch_norm=batch_norm, output_activation="sigmoid"),
            ta.DIN_Attention(D, attention_units=(16, 8), use_softmax=use_softmax,
                             batch_norm=batch_norm, output_activation="sigmoid"),
            inputs, train=batch_norm, grads=True)


@pytest.mark.parametrize("heads,use_scale,use_qkvo,masked", [
    (1, True, True, False), (2, True, True, True), (4, False, True, True),
    (2, True, False, True)])
def test_multi_head_target_attention(heads, use_scale, use_qkvo, masked):
    inputs = [_x(7, B, D), _x(8, B, L, D)] + ([_mask(2)] if masked else [])
    compare(ja.MultiHeadTargetAttention(D, 12 if use_qkvo else D, heads,
                                        use_scale=use_scale, use_qkvo=use_qkvo),
            ta.MultiHeadTargetAttention(D, 12 if use_qkvo else D, heads,
                                        use_scale=use_scale, use_qkvo=use_qkvo),
            inputs, grads=use_qkvo)


def _tied(seed):
    """Values of a few levels, both zeros among them: ties everywhere."""
    rng = np.random.RandomState(seed)
    x = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 1.0], np.float32), (B, 3, 7, 5))
    return x


@pytest.mark.parametrize("k,axis", [(3, -2), (2, 1), (1, -1), (5, 2), (7, -2)])
def test_k_max_pooling_ties(k, axis):
    """The k largest along ``axis`` in their original order, ties to the
    lower index, -0.0 below +0.0 as jax.lax.top_k orders them; exact."""
    x = _tied(k)
    want = np.asarray(ja.k_max_pooling(jnp.asarray(x), k, axis))
    got = ta.k_max_pooling(torch.from_numpy(x), k, axis).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_k_max_pooling_example_and_gradient():
    """[0, 1, 0, 2] with k=3 keeps index 0, not 2: [0, 1, 2]. The input
    gradient (a scatter to the kept positions) against jax.vjp."""
    x = torch.tensor([[0.0, 1.0, 0.0, 2.0]])
    assert ta.k_max_pooling(x, 3, -1).tolist() == [[0.0, 1.0, 2.0]]
    x = _tied(9) + 1e-3 * _x(10, B, 3, 7, 5)
    g = _x(11, B, 3, 3, 5)
    _, vjp = jax.vjp(lambda xx: ja.k_max_pooling(xx, 3, -2), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ta.k_max_pooling(xt, 3, -2) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-5)
