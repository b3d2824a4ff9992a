"""The port's optimizer (rat_tpu_torch.engine.optim) against the JAX
package's (rat_tpu.engine.optim, optax).

Regularizer parsing and the embedding/net split mirror
tests/test_trainer.py. One Adam step from the same parameters and the
same gradients, with the global-norm clip engaged and not, must equal
optax's update within 1e-6: both compute the same float32 formula,
only the order of a few operations differs."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rat_tpu.engine import optim as jopt
from rat_tpu_torch.engine.optim import (clip_grad_global_norm, get_learning_rate,
                                        get_optimizer, get_regularizer,
                                        is_embedding_param, regularization_loss,
                                        set_learning_rate)


def test_regularizer_parsing_matches_jax():
    for reg in (0.01, 0, "l2(1.e-4)", "l1(0.5)", "l1_l2(0.1, 0.2)", None, 0.03):
        assert get_regularizer(reg) == jopt.get_regularizer(reg)
    for bad in ("foo(1)", "l2(x)", [1]):
        with pytest.raises(NotImplementedError):
            get_regularizer(bad)


def test_regularization_split_by_name():
    ones = torch.ones((2, 2))
    named = [("embedding_layer.table", ones), ("dnn.linears.0.weight", ones)]
    # only embedding reg: (0.5/2)*||w||^2 = 0.25*4 = 1.0
    assert float(regularization_loss(named, 0.5, None)) == pytest.approx(1.0)
    assert float(regularization_loss(named, None, 0.5)) == pytest.approx(1.0)
    assert regularization_loss(named, None, 0) == 0.0
    # label_embedding_layer and the LR tower's table count as embedding
    for name in ("label_embedding_layer.table", "lr_layer.embedding_layer.table"):
        assert is_embedding_param(name)
        assert float(regularization_loss([(name, torch.ones(1, 4))], 0.5, None)) \
            == pytest.approx(1.0)
    assert not is_embedding_param("encoder.blocks.0.mlp.fc1.weight")


@pytest.mark.parametrize("reg", ["l1_l2(0.1, 0.2)", "l2(0.03)", "l1(0.5)"])
def test_regularization_matches_jax(reg):
    rng = np.random.RandomState(0)
    tree = {"embedding_layer": {"table": rng.randn(7, 3).astype(np.float32)},
            "dnn": {"kernel": rng.randn(3, 4).astype(np.float32)}}
    want = float(jopt.regularization_loss(tree, reg, "l2(0.01)"))
    named = [("embedding_layer.table", torch.from_numpy(tree["embedding_layer"]["table"])),
             ("dnn.kernel", torch.from_numpy(tree["dnn"]["kernel"]))]
    got = float(regularization_loss(named, reg, "l2(0.01)"))
    assert got == pytest.approx(want, rel=1e-6)


def _params_and_grads(seed, grad_scale):
    rng = np.random.RandomState(seed)
    shapes = {"a": (5, 3), "b": (3,), "c": (4, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (grad_scale * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
    return params, grads


@pytest.mark.parametrize("grad_scale,clipped", [(0.3, False), (10.0, True)])
def test_adam_step_matches_optax(grad_scale, clipped):
    """Two steps, so the moments chain; the second step's gradients
    differ from the first's."""
    lr, max_norm = 1e-3, 10.0
    params, g1 = _params_and_grads(0, grad_scale)
    _, g2 = _params_and_grads(1, grad_scale)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in g1.values()))
    assert (norm >= max_norm) == clipped

    tx = jopt.get_optimizer("adam", lr, max_norm)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = get_optimizer("adam", list(tparams.values()), lr, max_norm)
    for grads in (g1, g2):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6)
            if clipped:
                # the step moved every coordinate by about lr
                assert np.abs(p.detach().numpy() - params[k]).max() > 0.5 * lr


def test_learning_rate_is_in_param_groups():
    lr = 1e-3
    params, grads = _params_and_grads(2, 0.3)
    tx = jopt.get_optimizer("adam", lr, 10.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = get_optimizer("adam", list(tparams.values()), lr, 10.0)
    assert get_learning_rate(opt) == pytest.approx(lr)
    jopt.set_learning_rate(state, 1e-4)
    set_learning_rate(opt, 1e-4)
    assert get_learning_rate(opt) == pytest.approx(jopt.get_learning_rate(state))
    updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                               state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    for k, p in tparams.items():
        p.grad = torch.from_numpy(grads[k].copy())
    opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6)


def test_clip_is_optax_formula():
    """No epsilon: a norm of exactly max_norm is scaled by 1, and grads
    above it come out with exactly optax's values."""
    _, grads = _params_and_grads(3, 10.0)
    tparams = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads.values()]
    for p, g in zip(tparams, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_grad_global_norm(tparams, 5.0)
    clip = optax.clip_by_global_norm(5.0)
    want, _ = clip.update({k: jnp.asarray(v) for k, v in grads.items()},
                          clip.init(None))
    assert float(norm) == pytest.approx(float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()})), rel=1e-6)
    for p, k in zip(tparams, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    new_norm = float(clip_grad_global_norm(tparams, 5.0))
    assert new_norm == pytest.approx(5.0, rel=1e-6)


def test_only_adam_is_ported():
    with pytest.raises(NotImplementedError):
        get_optimizer("sgd", [torch.nn.Parameter(torch.zeros(1))], 1e-3)
