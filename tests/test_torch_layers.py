"""The port's layers (rat_tpu_torch.nn.layers) against the JAX package's
(rat_tpu.nn.layers), on seeded numpy inputs on the CPU: BatchNorm,
the MLP tower with BatchNorm, the pre-norm Transformer, the attention
core of RAT_m3, and dropout. Weights are carried across by
``params_from_jax``'s leaf rules (flax [in, out] kernels become
nn.Linear [out, in]); each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.nn import layers as jl
from rat_tpu_torch.convert import torch_name
from rat_tpu_torch.nn import layers as tl


def _load(module, params, stats, flax_prefix, torch_prefix):
    """Load a flax sub-tree into ``module``: its paths get the prefix
    they have in a RATModel tree, so that the converter's rules apply,
    and the state-dict names lose the module's prefix again."""
    state = {}
    for tree in (params, stats or {}):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name, transpose = torch_name(flax_prefix + "/".join(k.key for k in path))
            assert name.startswith(torch_prefix), name
            arr = np.array(leaf, np.float32)
            state[name[len(torch_prefix):]] = torch.from_numpy(
                np.ascontiguousarray(arr.T if transpose else arr))
    module.load_state_dict(state)
    return module


def _bn_stats(module):
    return {"mean": module.running_mean.numpy(), "var": module.running_var.numpy()}


@pytest.mark.parametrize("case", ["n1", "n2", "padded", "grid"])
def test_batchnorm_matches_jax(case):
    """Train output, the updated running statistics, then the eval output
    on them, at one row (torch's BatchNorm1d refuses it in training; the
    JAX module divides by max(n - 1, 1)), two rows, a batch padded by
    repeating row 0 (the Trainer's last batch: the padded rows enter the
    statistics) and a 3-d input (statistics over the two leading axes).
    Outputs within rtol 1e-5 / atol 1e-6, statistics within 1e-6."""
    rng = np.random.RandomState(3)
    x = {"n1": rng.randn(1, 6), "n2": rng.randn(2, 6), "padded": rng.randn(5, 6),
         "grid": rng.randn(4, 3, 6)}[case].astype(np.float32)
    if case == "padded":
        x = np.concatenate([x, np.repeat(x[:1], 3, axis=0)])
    scale = (1 + 0.2 * rng.randn(6)).astype(np.float32)
    bias = (0.3 * rng.randn(6)).astype(np.float32)
    mean0 = (0.1 * rng.randn(6)).astype(np.float32)
    var0 = (1 + 0.1 * rng.rand(6)).astype(np.float32)

    jbn = jl.TorchBatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jy, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    jeval = jl.TorchBatchNorm(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]},
        jnp.asarray(x))

    bn = tl.TorchBatchNorm(6)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    y = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    for k, v in _bn_stats(bn).items():
        np.testing.assert_allclose(v, np.asarray(mutated["batch_stats"][k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    with torch.no_grad():
        np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).numpy(),
                                   np.asarray(jeval), rtol=1e-5, atol=1e-6)
    assert {n for n, _ in bn.named_buffers()} == {"running_mean", "running_var"}
    assert {n for n, _ in bn.named_parameters()} == {"weight", "bias"}


@pytest.mark.parametrize("batch_norm", [True, False], ids=["bn", "no_bn"])
def test_mlp_matches_jax(batch_norm):
    """MLPLayer (Linear -> BatchNorm -> relu per hidden layer, output
    Linear) in train and then eval mode: outputs within rtol 1e-5 / atol
    1e-6, the gradient of the input in training within rtol 1e-5 / atol
    1e-6 of its scale, the running statistics within 1e-6."""
    rng = np.random.RandomState(4)
    x = rng.randn(9, 12).astype(np.float32)
    g = rng.randn(9, 1).astype(np.float32)
    jm = jl.MLPLayer(input_dim=12, output_dim=1, hidden_units=(16, 8),
                     batch_norm=batch_norm)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    # non-trivial BN parameters, so that scale and bias are exercised
    v = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.asarray(
        np.random.RandomState(a.size).randn(*a.shape), a.dtype), v)

    def train_out(xx):
        return jm.apply(v, xx, train=True, mutable=["batch_stats"])

    jy, mutated = train_out(jnp.asarray(x))
    jdx = jax.grad(lambda xx: jnp.sum(train_out(xx)[0] * g))(jnp.asarray(x))
    jeval = jm.apply({"params": v["params"], **mutated}, jnp.asarray(x), train=False)

    m = tl.MLPLayer(12, 1, (16, 8), batch_norm=batch_norm)
    _load(m, v["params"], v.get("batch_stats"), "dnn/", "dnn.")
    xt = torch.from_numpy(x).requires_grad_()
    y = m.train()(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jdx)).max())
    if batch_norm:
        for i, norm in enumerate(m.norms):
            for k, val in _bn_stats(norm).items():
                np.testing.assert_allclose(
                    val, np.asarray(mutated["batch_stats"]["TorchBatchNorm_{}".format(i)][k]),
                    rtol=0, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(torch.from_numpy(x)).numpy(),
                                   np.asarray(jeval), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads,dim_head", [(2, 4), (1, 8), (4, 3)])
def test_transformer_matches_jax(heads, dim_head):
    """The pre-norm Transformer (attn_{i} / ff_{i} and a final LayerNorm)
    at depth 2: output within rtol 1e-5 / atol 1e-5, input gradient
    within rtol 1e-5 / atol 1e-6 of its scale; (1, 8) has heads = 1 and
    dim_head = dim, so no output projection."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 7, 8).astype(np.float32)
    g = rng.randn(6, 7, 8).astype(np.float32)
    jt = jl.Transformer(dim=8, depth=2, heads=heads, dim_head=dim_head, mlp_dim=16)
    v = jt.init(jax.random.PRNGKey(1), jnp.asarray(x))
    jy = jt.apply(v, jnp.asarray(x))
    jdx = jax.grad(lambda xx: jnp.sum(jt.apply(v, xx) * g))(jnp.asarray(x))

    t = _load(tl.Transformer(8, 2, heads, dim_head, 16), v["params"], None,
              "JointEncoder_0/encoder/", "encoder.encoder.")
    xt = torch.from_numpy(x).requires_grad_()
    y = t(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jdx)).max())
    assert hasattr(t, "attn_1") and hasattr(t, "ff_1") and not hasattr(t, "attn_2")


@pytest.mark.parametrize("heads,inner,scale", [(1, 8, 4 ** -0.5), (2, 8, 2 ** -0.5),
                                               (2, 12, 3 ** -0.5)])
def test_mhsa_takes_heads_and_scale_apart(heads, inner, scale):
    """The attention core RAT_m3 needs: heads of width inner / heads but
    any scale; within rtol 1e-5 / atol 1e-6 of the JAX _mhsa."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(5, 6, inner).astype(np.float32) for _ in range(3))
    want = np.asarray(jl._mhsa_batch_major(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           heads, scale))
    got = tl.mhsa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  heads, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_dropout_rate_zero_and_eval_are_exact():
    x = torch.from_numpy(np.random.RandomState(7).randn(50, 20).astype(np.float32))
    assert torch.equal(tl.Dropout(0.0).train()(x), x)
    assert torch.equal(tl.Dropout(0.3).eval()(x), x)
    assert torch.equal(tl.Dropout(1.0).train()(x), torch.zeros_like(x))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_and_scales(p):
    """The keep share of 200,000 draws within 5 binomial standard
    deviations of 1 - p; kept values are exactly x / (1 - p)."""
    n = 200_000
    x = torch.from_numpy(np.random.RandomState(8).rand(n).astype(np.float32) + 0.5)
    drop = tl.Dropout(p).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    kept = y != 0
    share = kept.double().mean().item()
    assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n), share
    assert torch.equal(y[kept], x[kept] / (1 - p))


def test_dropout_generator_gives_the_mask():
    """The same generator seed gives the same masks, through a model's
    every Dropout (set_dropout_generator); another seed another."""
    x = torch.ones(64, 32)

    def masks(seed):
        ff = tl.FeedForward(32, 16, dropout=0.5, generator=torch.Generator().manual_seed(1))
        tl.set_dropout_generator(ff, torch.Generator().manual_seed(seed))
        assert ff.drop.generator is not None
        return ff.train()(x), ff(x)

    a, b, c = masks(3), masks(3), masks(4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


def test_dropout_placement_in_attention_and_feedforward():
    """Attention drops after its output projection only when it has one;
    FeedForward after the GELU and after the second Linear: in training
    with p = 1 the first gives zeros and the second gives exactly
    fc2's bias dropped, i.e. zeros; without a projection nothing drops."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, 8, generator=gen)
    assert torch.equal(tl.Attention(8, 2, 4, dropout=1.0, generator=gen).train()(x),
                       torch.zeros(3, 5, 8))
    no_proj = tl.Attention(8, 1, 8, dropout=1.0, generator=gen)
    assert no_proj.to_out is None
    assert torch.equal(no_proj.train()(x), no_proj.eval()(x))
    assert torch.equal(tl.FeedForward(8, 16, dropout=1.0, generator=gen).train()(x),
                       torch.zeros(3, 5, 8))
