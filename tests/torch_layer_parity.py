"""Hold a layer of the port's NN library against the JAX package's on
the same seeded inputs, for the tests/test_torch_{interaction,
attention_lib,deep,graph,feature_embedding}.py files: the flax module is
initialised from ``jax.random.PRNGKey``, its variables carried across by
``layer_params_from_jax`` (strictly: every torch parameter and buffer
must have a flax counterpart), then the outputs are compared and, where
asked, the parameter gradients of sum(output * G) for a seeded G, and
BatchNorm's running statistics after a train-mode call (assert_close:
the absolute tolerance at the scale of the largest value above 1). The JAX
forward runs eagerly, op by op as torch runs (XLA's fusions round the
InteractionMachine's order-5 cancellation otherwise); its gradient runs
under ``jax.jit`` (eagerly, a flax gradient takes seconds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu_torch.convert import layer_params_from_jax, layer_torch_name

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def assert_close(got, want, tol, err_msg=""):
    """Within ``tol``, its atol taken at the scale of ``want``'s largest
    |value| where that is above 1: a sum of many float32 terms of that
    size is rounded at that size, and summed in another order by each
    package (the gradients of the graph layers reach ~40 at B=5)."""
    atol = tol["atol"] * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol, err_msg=err_msg)
# zero-initialised leaves get noise, so that biases, BatchNorm's scale and
# Dice's alpha take part in the comparison
_PERTURB = ("bias", "bias_p", "alpha", "scale")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree):
    return [("/".join(str(k.key) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _perturb(variables, seed):
    rng = np.random.RandomState(seed)

    def bump(path, leaf):
        name = str(path[-1].key)
        if name in _PERTURB:
            return leaf + 0.1 * jnp.asarray(rng.randn(*leaf.shape), leaf.dtype)
        if name == "mean":
            return leaf + 0.1 * jnp.asarray(rng.randn(*leaf.shape), leaf.dtype)
        if name == "var":
            return leaf + 0.2 * jnp.asarray(rng.rand(*leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(bump, variables)


def _leaves(out):
    if isinstance(out, dict):
        return list(out.values())
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


def _torch_input(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def compare(jmod, tmod, inputs, *, kw=None, train=None, grads=False, seed=0,
            out_tol=OUT_TOL, grad_tol=GRAD_TOL, perturb=True, jit_grad=True):
    """Run the flax ``jmod`` and the port's ``tmod`` on ``inputs`` (numpy
    arrays; integer arrays become int64 tensors) and compare.

    ``kw``: keyword arguments of both calls; ``train``: None for a module
    without a train flag, else the flag (train=True also compares the
    updated batch statistics); ``grads``: compare the parameter
    gradients too; ``jit_grad=False``: take the JAX gradient eagerly.
    Returns the torch outputs."""
    kw = dict(kw or {})
    jin = [jnp.asarray(a) for a in inputs]
    jkw = dict(kw) if train is None else dict(kw, train=train)
    variables = dict(jmod.init(jax.random.PRNGKey(seed), *jin,
                               **(kw if train is None else dict(kw, train=False))))
    if perturb:
        variables = _perturb(variables, seed + 1)
    params, stats = variables.get("params", {}), variables.get("batch_stats")
    tmod.load_state_dict(layer_params_from_jax(params, stats), strict=True)
    tmod.train(bool(train))

    def jforward(p):
        v = dict(variables, params=p)
        if train:
            return jmod.apply(v, *jin, mutable=["batch_stats"], **jkw)
        return jmod.apply(v, *jin, **jkw), None

    jout, mutated = jforward(params)
    jleaves = [np.asarray(a) for a in _leaves(jout)]
    tin = [_torch_input(a) for a in inputs]
    tout = tmod(*tin, **kw)
    tleaves = _leaves(tout)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape
        assert_close(t.detach().numpy(), j, out_tol)
    if train and mutated:
        buffers = dict(tmod.named_buffers())
        for path, leaf in _paths(mutated["batch_stats"]):
            name, _ = layer_torch_name(path)
            np.testing.assert_allclose(buffers[name].numpy(), np.asarray(leaf),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    if grads:
        rng = np.random.RandomState(seed + 2)
        G = [rng.randn(*j.shape).astype(np.float32) for j in jleaves]

        def jloss(p):
            return sum(jnp.sum(o * g) for o, g in zip(_leaves(jforward(p)[0]), G))

        grad = jax.grad(jloss)
        jgrads = (jax.jit(grad) if jit_grad else grad)(params)
        sum((o * torch.from_numpy(g)).sum() for o, g in zip(tleaves, G)).backward()
        tparams = dict(tmod.named_parameters())
        seen = set()
        for path, leaf in _paths(jgrads):
            name, transpose = layer_torch_name(path)
            seen.add(name)
            grad = tparams[name].grad
            got = np.zeros(tparams[name].shape, np.float32) if grad is None \
                else grad.numpy()
            want = np.asarray(leaf)
            assert_close(got, want.T if transpose else want, grad_tol, err_msg=name)
        assert seen == set(tparams), set(tparams) ^ seen
    return tout
