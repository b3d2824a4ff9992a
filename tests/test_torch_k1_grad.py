"""The mathematics of K1's backward kernel (csrc/cross_intra_block.cu,
``k1_grad_kernel``), written out as the formulas it implements, against
autograd of the port's plain block in float64 and against ``jax.vjp`` of
the JAX package's plain block; and the backward's dispatch and counters
on CPU tensors.

The kernel itself runs only on a card (chip_smoke.py's K1 grad phase
holds it to autograd of the plain block there). These formulas follow
its steps: recompute the block's forward keeping the residual stream
after each sub-block, then go back through the FF (exact GELU), the
cross attention with LN2 and the intra attention with LN1, each
attention head by head, with the weight gradients summed over the
batch. A wrong derivative shows here before it reaches the card."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.ops.pallas.cross_intra_block import \
    cross_intra_block_reference as jax_block
from rat_tpu_torch import tracing
from rat_tpu_torch.ops import cross_intra_block as k1

# (B, t, s, d, heads, dim_head): ML-Tag's block, KKBox's, heads 1 with
# dim_head == d (no project_out), and a batch that is no multiple of 8
SHAPES = {
    "mltag": (8, 6, 4, 10, 2, 10),
    "kkbox": (3, 6, 14, 40, 8, 10),
    "heads1_dh_eq_d": (5, 6, 4, 10, 1, 10),
    "mltag_b13": (13, 6, 4, 10, 2, 10),
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(rng, d, heads, dim_head, hidden, project_out):
    """The 14 weights in nn.Linear layout ([out, in]), float64 numpy;
    w_out*/b_out* None without project_out."""
    inner = heads * dim_head

    def w(out_dim, in_dim):
        return rng.randn(out_dim, in_dim) / np.sqrt(in_dim)

    p = {}
    for i in ("1", "2"):
        p["ln" + i + "_scale"] = 1 + 0.1 * rng.randn(d)
        p["ln" + i + "_bias"] = 0.1 * rng.randn(d)
        p["w_qkv" + i] = w(3 * inner, d)
        p["w_out" + i] = w(d, inner) if project_out else None
        p["b_out" + i] = 0.1 * rng.randn(d) if project_out else None
    p["ff_w1"] = w(hidden, d)
    p["ff_b1"] = 0.1 * rng.randn(hidden)
    p["ff_w2"] = w(d, hidden)
    p["ff_b2"] = 0.1 * rng.randn(d)
    return p


def _case(name, seed, dtype):
    B, t, s, d, heads, dim_head = SHAPES[name]
    project_out = not (heads == 1 and dim_head == d)
    rng = np.random.RandomState(seed)
    p = _weights(rng, d, heads, dim_head, 4 * d, project_out)
    x = rng.randn(B, t, s, d)
    g = rng.randn(B, t, s, d)

    def cast(a):
        return None if a is None else torch.from_numpy(np.asarray(a, dtype))

    return (cast(x), {k: cast(v) for k, v in p.items()}, cast(g), heads, dim_head,
            project_out)


def _grouped(h, t, s, a):
    """[B, n, d] tokens (n = t * s, token ti * s + si) -> the attention
    groups of sub-block a: [B * t, s, d] for the intra attention (a = 0),
    [B * s, t, d] for the cross attention (a = 1)."""
    B, _, d = h.shape
    h = h.reshape(B, t, s, d)
    return h.reshape(B * t, s, d) if a == 0 else h.transpose(1, 2).reshape(B * s, t, d)


def _tokens(h, B, t, s, a):
    """The inverse of :func:`_grouped`."""
    d = h.shape[-1]
    if a == 0:
        return h.reshape(B, t * s, d)
    return h.reshape(B, s, t, d).transpose(1, 2).reshape(B, t * s, d)


def _layer_norm(x, w, b):
    """LayerNorm (eps 1e-5): (output, x-hat, 1/std per row)."""
    mu = x.mean(-1, keepdim=True)
    rs = 1.0 / torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (x - mu) * rs
    return xhat * w + b, xhat, rs


def _heads(m, heads, dim_head):
    """[N, L, heads * dim_head] -> [N, heads, L, dim_head]."""
    N, L, _ = m.shape
    return m.reshape(N, L, heads, dim_head).transpose(1, 2)


def _attention_forward(xg, p, a, heads, dim_head, project_out):
    """One sub-block on grouped rows xg [N, L, d]: its output and what its
    backward reads (LN's x-hat and 1/std, xn, q, k, v, the attention
    weights and the heads' output)."""
    i = str(a + 1)
    xn, xhat, rs = _layer_norm(xg, p["ln" + i + "_scale"], p["ln" + i + "_bias"])
    q, k, v = (_heads(m, heads, dim_head)
               for m in (xn @ p["w_qkv" + i].T).chunk(3, dim=-1))
    att = torch.softmax(q @ k.transpose(-1, -2) * dim_head ** -0.5, dim=-1)
    o = (att @ v).transpose(1, 2).reshape(xg.shape[0], xg.shape[1], -1)
    out = o @ p["w_out" + i].T + p["b_out" + i] if project_out else o
    return xg + out, (xhat, rs, xn, q, k, v, att, o)


def _attention_backward(dy, saved, p, a, heads, dim_head, project_out, grads):
    """The gradient of sub-block a's input from that of its output dy
    (grouped rows), adding its weights' gradients to ``grads``."""
    i = str(a + 1)
    xhat, rs, xn, q, k, v, att, o = saved
    scale = dim_head ** -0.5
    if project_out:
        grads["w_out" + i] = torch.einsum("nle,nlc->ec", dy, o)
        grads["b_out" + i] = dy.sum((0, 1))
        do = dy @ p["w_out" + i]
    else:
        do = dy
    do = _heads(do, heads, dim_head)
    dp = do @ v.transpose(-1, -2)                              # [N, H, Lq, Lk]
    ds = att * (dp - (att * dp).sum(-1, keepdim=True))
    dq = scale * ds @ k
    dk = scale * ds.transpose(-1, -2) @ q
    dv = att.transpose(-1, -2) @ do

    def flat(m):
        return m.transpose(1, 2).reshape(dy.shape[0], dy.shape[1], -1)

    dqkv = torch.cat([flat(dq), flat(dk), flat(dv)], dim=-1)    # [N, L, 3 * inner]
    grads["w_qkv" + i] = torch.einsum("nlc,nle->ce", dqkv, xn)
    dxn = dqkv @ p["w_qkv" + i]
    grads["ln" + i + "_scale"] = (dxn * xhat).sum((0, 1))
    grads["ln" + i + "_bias"] = dxn.sum((0, 1))
    dxh = dxn * p["ln" + i + "_scale"]
    dln = rs * (dxh - dxh.mean(-1, keepdim=True)
                - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return dy + dln


def k1_backward_formulas(x, p, g, heads, dim_head, project_out=True):
    """dx and {weight: gradient} of the block for the cotangent g, by the
    formulas K1's backward kernel implements."""
    B, t, s, d = x.shape
    n = t * s
    x0 = x.reshape(B, n, d)
    # the forward, keeping the residual stream after each sub-block
    x1, saved1 = _attention_forward(_grouped(x0, t, s, 0), p, 0, heads, dim_head,
                                    project_out)
    x1 = _tokens(x1, B, t, s, 0)
    x2, saved2 = _attention_forward(_grouped(x1, t, s, 1), p, 1, heads, dim_head,
                                    project_out)
    x2 = _tokens(x2, B, t, s, 1)
    # FF, exact GELU: gelu(u) = u Phi(u), gelu'(u) = Phi(u) + u phi(u)
    u = x2 @ p["ff_w1"].T + p["ff_b1"]
    cdf = 0.5 * (1.0 + torch.erf(u / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    G = g.reshape(B, n, d)
    du = (G @ p["ff_w2"]) * (cdf + u * pdf)
    grads = {"ff_w2": torch.einsum("bne,bnk->ek", G, u * cdf), "ff_b2": G.sum((0, 1)),
             "ff_w1": torch.einsum("bnk,bne->ke", du, x2), "ff_b1": du.sum((0, 1))}
    dx = G + du @ p["ff_w1"]
    # the cross attention with LN2, then the intra attention with LN1
    dx = _tokens(_attention_backward(_grouped(dx, t, s, 1), saved2, p, 1, heads, dim_head,
                                     project_out, grads), B, t, s, 1)
    dx = _tokens(_attention_backward(_grouped(dx, t, s, 0), saved1, p, 0, heads, dim_head,
                                     project_out, grads), B, t, s, 0)
    return dx.reshape(B, t, s, d), grads


def _autograd(x, p, g, heads, dim_head, project_out):
    """dx and {weight: gradient} by autograd of the port's plain block."""
    xt = x.clone().requires_grad_()
    pt = {k: None if v is None else v.clone().requires_grad_() for k, v in p.items()}
    out = k1.cross_intra_block_reference(xt, pt, heads, dim_head, project_out)
    names = [k for k in k1.PARAM_ORDER if pt[k] is not None]
    got = torch.autograd.grad(out, [xt] + [pt[k] for k in names], g)
    return got[0], dict(zip(names, got[1:]))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_formulas_match_autograd_float64(name, one_thread):
    """In float64 the formulas and autograd of the plain block agree to
    rounding (rtol 1e-9, atol 1e-10 of each gradient's largest value),
    for dx and every weight; without project_out no gradient of w_out* /
    b_out* is formed."""
    x, p, g, heads, dim_head, project_out = _case(name, 5, np.float64)
    dx, grads = k1_backward_formulas(x, p, g, heads, dim_head, project_out)
    want_dx, want = _autograd(x, p, g, heads, dim_head, project_out)
    assert sorted(grads) == sorted(want)
    for key, got, ref in [("x", dx, want_dx)] + [(k, grads[k], want[k]) for k in want]:
        assert got.shape == ref.shape, key
        torch.testing.assert_close(got, ref, rtol=1e-9, atol=1e-10 * ref.abs().max().item(),
                                   msg=key)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_formulas_match_jax_vjp(name, one_thread):
    """The formulas, in float64 on float32 inputs, against ``jax.vjp`` of
    the JAX package's plain block in float32: within rtol 1e-5 and an
    atol of 1e-6 of the gradient's largest magnitude, the float32 noise
    of JAX's own sums (as in test_torch_cross_intra_block.py). JAX's
    weights are [in, out]; without project_out JAX is fed zero
    projections, whose gradients are not compared."""
    x, p, g, heads, dim_head, project_out = _case(name, 9, np.float32)
    d = x.shape[-1]
    jp = {}
    for k, v in p.items():
        if v is None:
            jp[k] = jnp.zeros((d, d) if k.startswith("w_out") else (d,), jnp.float32)
        else:
            jp[k] = jnp.asarray(v.numpy().T if v.dim() == 2 else v.numpy())

    @jax.jit
    def vjp(x_, p_, g_):
        return jax.vjp(lambda a, b: jax_block(a, b, heads, dim_head,
                                              project_out=project_out), x_, p_)[1](g_)

    jdx, jdp = vjp(jnp.asarray(x.numpy()), jp, jnp.asarray(g.numpy()))
    dx, grads = k1_backward_formulas(x.double(), {k: None if v is None else v.double()
                                                  for k, v in p.items()},
                                     g.double(), heads, dim_head, project_out)

    def close(got, want, key):
        want = np.asarray(want, np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=key)

    close(dx.numpy(), jdx, "x")
    for k, got in grads.items():
        got = got.numpy()
        close(got.T if got.ndim == 2 else got, jdp[k], k)


def test_cpu_backward_is_autograd_of_the_plain_block(one_thread):
    """On CPU tensors the Function's backward is autograd of the plain
    block, bit for bit, and moves none of the backward's counters;
    ``tracing.counters()`` carries all three."""
    x, p, g, heads, dim_head, project_out = _case("mltag", 3, np.float32)
    want_dx, want = _autograd(x, p, g, heads, dim_head, project_out)
    before = (k1.grad_launches, k1.grad_captured, k1.grad_plain)
    xt = x.clone().requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = k1.cross_intra_block(xt, pt, heads, dim_head, project_out)
    out.backward(g)
    assert (k1.grad_launches, k1.grad_captured, k1.grad_plain) == before
    assert torch.equal(xt.grad, want_dx)
    for k, ref in want.items():
        assert torch.equal(pt[k].grad, ref), k
    counters = tracing.counters()
    for key in ("grad_launches", "grad_captured", "grad_plain"):
        assert counters["cross_intra_block." + key] == getattr(k1, key)
