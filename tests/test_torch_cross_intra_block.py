"""Kernel K1's plain version (rat_tpu_torch.ops.cross_intra_block)
against the JAX package's ``cross_intra_block_reference``, forward and,
through the port's ``torch.autograd.Function``, backward against
``jax.vjp``.

Same float32 inputs from a seeded numpy RNG go through both; the port's
weights are the JAX ones transposed to nn.Linear layout. The two differ
only in the order of float32 sums; the forward's tolerance is stated in
its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.ops.pallas.cross_intra_block import \
    cross_intra_block_reference as jax_block
from rat_tpu_torch.ops import cross_intra_block as k1


def _weights(rng, d, heads, dim_head, hidden, project_out):
    """JAX-layout ([in, out]) block weights."""
    inner = heads * dim_head

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    p = {}
    for i in ("1", "2"):
        p["ln" + i + "_scale"] = (1 + 0.1 * rng.randn(d)).astype(np.float32)
        p["ln" + i + "_bias"] = (0.1 * rng.randn(d)).astype(np.float32)
        p["w_qkv" + i] = w(d, 3 * inner)
        p["w_out" + i] = w(inner, d) if project_out else np.zeros((d, d), np.float32)
        p["b_out" + i] = (0.1 * rng.randn(d)).astype(np.float32) if project_out \
            else np.zeros((d,), np.float32)
    p["ff_w1"] = w(d, hidden)
    p["ff_b1"] = (0.1 * rng.randn(hidden)).astype(np.float32)
    p["ff_w2"] = w(hidden, d)
    p["ff_b2"] = (0.1 * rng.randn(d)).astype(np.float32)
    return p


def _to_torch(p, project_out):
    out = {}
    for k, v in p.items():
        if not project_out and k[:5] in ("w_out", "b_out"):
            out[k] = None
            continue
        out[k] = torch.from_numpy(np.ascontiguousarray(v.T if v.ndim == 2 else v))
    return out


# (B, t, s, d, heads, dim_head): ML-Tag block, KKBox-like, heads=1 dh=d
SHAPES = {
    "mltag": (16, 6, 4, 10, 2, 10),
    "kkbox": (4, 6, 14, 40, 8, 10),
    "single_head_dh_eq_d": (8, 6, 4, 10, 1, 10),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_block_matches_jax_reference(name):
    """Forward within rtol 1e-5 / atol 1e-5. XLA's CPU matmuls and
    torch's sum float32 products in another order, and the gap depends
    on the machine's kernels: at the KKBox shape (d=40, an FF of 160)
    3 of the 13,440 outputs, all near 3e-3, differ by up to 1.3e-6
    (relative 4.3e-4), so an atol of 1e-6 failed on some machines and not on
    others. 1e-5 is the tolerance the JAX package holds its own kernel
    to (tests/test_pallas.py) and the card holds K1 to."""
    B, t, s, d, heads, dim_head = SHAPES[name]
    project_out = not (heads == 1 and dim_head == d)
    rng = np.random.RandomState(7)
    x = rng.randn(B, t, s, d).astype(np.float32)
    p = _weights(rng, d, heads, dim_head, 4 * d, project_out)
    want = np.asarray(jax_block(jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in p.items()},
                                heads, dim_head, project_out=project_out))
    before = k1.launches
    got = k1.cross_intra_block(torch.from_numpy(x), _to_torch(p, project_out),
                               heads, dim_head, project_out=project_out)
    assert k1.launches == before, "a CPU call must not count as a launch"
    assert got.shape == x.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version():
    B, t, s, d, heads, dim_head = SHAPES["mltag"]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32))
    p = _to_torch(_weights(rng, d, heads, dim_head, 4 * d, True), True)
    torch.testing.assert_close(
        k1.cross_intra_block(x, p, heads, dim_head),
        k1.cross_intra_block_reference(x, p, heads, dim_head), rtol=0, atol=0)


# the forward shapes, plus a batch that is not a multiple of 8 (the JAX
# kernel's block; the port's takes any B)
GRAD_SHAPES = dict(SHAPES, mltag_b13=(13, 6, 4, 10, 2, 10))


@pytest.mark.parametrize("name", sorted(GRAD_SHAPES))
def test_function_gradients_match_jax_vjp(name):
    """dx and every weight gradient of the autograd.Function equal
    jax.vjp of the JAX plain block for the same cotangent, within rtol
    1e-5 and an atol of 1e-6 of the gradient's largest magnitude. The
    atol scales because a backward's float32 sums carry noise of that
    size in every implementation: at the ML-Tag shape, the JAX package's
    own float32 dx is 7.6e-6 from the float64 value (scale 18), and its
    weight gradients up to 6.4e-7 of their scale; a fixed atol of 1e-6
    fails on 0.1-0.4% of the elements for that noise alone. Without
    project_out the port's w_out/b_out are None and get no gradient;
    JAX's zero placeholders get zero gradients."""
    B, t, s, d, heads, dim_head = GRAD_SHAPES[name]
    project_out = not (heads == 1 and dim_head == d)
    rng = np.random.RandomState(11)
    x = rng.randn(B, t, s, d).astype(np.float32)
    p = _weights(rng, d, heads, dim_head, 4 * d, project_out)
    g = rng.randn(B, t, s, d).astype(np.float32)

    @jax.jit
    def jax_vjp(x_, p_, g_):
        return jax.vjp(lambda a, b: jax_block(a, b, heads, dim_head,
                                              project_out=project_out), x_, p_)[1](g_)

    jdx, jdp = jax_vjp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    tp = _to_torch(p, project_out)
    for w in tp.values():
        if w is not None:
            w.requires_grad_()
    out = k1.cross_intra_block(xt, tp, heads, dim_head, project_out=project_out)
    assert type(out.grad_fn).__name__ == "CrossIntraBlockBackward"
    out.backward(torch.from_numpy(g))

    def close(got, want, name):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)

    close(xt.grad.numpy(), np.asarray(jdx), "x")
    for k in k1.PARAM_ORDER:
        want = np.asarray(jdp[k])
        if tp[k] is None:
            assert not project_out and not want.any(), k
            continue
        got = tp[k].grad.numpy()
        close(got.T if got.ndim == 2 else got, want, k)


def test_function_under_no_grad_is_the_forward():
    B, t, s, d, heads, dim_head = SHAPES["mltag"]
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32))
    p = _to_torch(_weights(rng, d, heads, dim_head, 4 * d, True), True)
    for w in p.values():
        w.requires_grad_()
    with torch.no_grad():
        out = k1.cross_intra_block(x, p, heads, dim_head)
    assert out.grad_fn is None and not out.requires_grad
    torch.testing.assert_close(
        out, k1.cross_intra_block_reference(x, p, heads, dim_head).detach(),
        rtol=0, atol=0)
