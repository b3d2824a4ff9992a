"""The port's packed embedding (rat_tpu_torch.nn.embedding) against the
JAX package's, on the CPU, over a feature map with every kind of field:
categorical, numeric, sequence, pretrained rows in the packed table
(frozen and trainable) and pretrained fields of another width with
their own side table and hook projection (frozen and trainable). The
pretrained rows come from an h5 file the test writes under the map's
data_dir. Both packages start from the same weights (the JAX init,
carried across by ``params_from_jax``); each test states its
tolerance."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.engine.optim import regularization_loss as jax_reg
from rat_tpu.features import FeatureMap as JFeatureMap
from rat_tpu.models import build_model as jbuild
from rat_tpu.nn.embedding import EmbeddingSpec as JSpec
from rat_tpu.nn.embedding import PackedEmbedding as JEmbedding
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.engine.optim import regularization_loss
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.models import build_model
from rat_tpu_torch.nn.embedding import EmbeddingSpec, PackedEmbedding

D = 4
PRETRAINED = {"item": (9, D), "genre": (6, D), "artist": (8, 5), "tags": (7, 3)}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _specs():
    pre = {"pretrained_emb": "pretrained.h5"}
    return {
        "user": {"type": "categorical", "vocab_size": 7, "index": 0},
        "price": {"type": "numeric", "index": 1},
        "item": dict(pre, type="categorical", vocab_size=9, index=2, freeze_emb=True),
        "genre": dict(pre, type="sequence", vocab_size=6, index=[3, 4, 5], max_len=3,
                      encoder="MaskedAveragePooling", freeze_emb=False),
        "artist": dict(pre, type="categorical", vocab_size=8, index=6, embedding_dim=5,
                       freeze_emb=True),
        "tags": dict(pre, type="sequence", vocab_size=7, index=[7, 8], max_len=2,
                     encoder="MaskedSumPooling", embedding_dim=3, freeze_emb=False),
        "age": {"type": "numeric", "index": 9},
    }


@pytest.fixture()
def maps(tmp_path):
    """(JAX feature map, port feature map), both reading the h5 file of
    pretrained rows written here."""
    rng = np.random.RandomState(11)
    with h5py.File(os.path.join(str(tmp_path), "pretrained.h5"), "w") as hf:
        for name, shape in PRETRAINED.items():
            hf.create_dataset(name, data=rng.randn(*shape).astype(np.float32))
    jfm = JFeatureMap("emb", str(tmp_path))
    jfm.feature_specs = _specs()
    jfm.num_fields, jfm.num_features, jfm.input_length = 7, 37, 10
    fm = FeatureMap("emb", str(tmp_path))
    fm.from_dict(jfm.to_dict())
    return jfm, fm


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    X = np.stack([rng.randint(0, v, shape) for v in (7, 1, 9, 6, 6, 6, 8, 7, 7, 1)],
                 axis=-1).astype(np.int32)
    X[..., 5] = 5                       # genre padding (id vocab - 1) ...
    X[0, ..., 3:6] = 5                  # ... and an all-padding sequence
    X[..., 8] = 6                       # tags padding
    Xf = rng.randn(*shape, 10).astype(np.float32)
    return X, Xf


def _jax_embedding(jfm):
    spec = JSpec.build(jfm, D)
    return JEmbedding(spec, D, data_dir=jfm.data_dir)


def test_pretrained_rows_and_side_tables_load(maps):
    """The packed table holds the h5 rows of ``item`` and ``genre`` at
    their offsets, the side tables the h5 rows of ``artist`` and
    ``tags``, exactly as the JAX init, and the other weights have the
    JAX init's shapes."""
    jfm, fm = maps
    X, Xf = _inputs(0, (3,))
    jp = _jax_embedding(jfm).init(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(Xf))
    emb = PackedEmbedding(EmbeddingSpec.build(fm, D), D, data_dir=fm.data_dir,
                          generator=torch.Generator().manual_seed(0))
    with h5py.File(os.path.join(fm.data_dir, "pretrained.h5"), "r") as hf:
        h5 = {k: hf[k][:] for k in hf}
    for name, info in emb.spec.pretrained.items():
        if info["side"]:
            np.testing.assert_array_equal(getattr(emb, "side_" + name).detach().numpy(),
                                          h5[name])
        else:
            rows = emb.table[info["offset"]: info["offset"] + info["rows"]]
            np.testing.assert_array_equal(rows.detach().numpy(), h5[name])
    state = {k.split(".", 1)[1]: v for k, v in
             params_from_jax({"embedding_layer": jp["params"]}).items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in emb.state_dict().items()}
    assert set(state) == {"table", "numeric_weights", "side_artist", "hook_artist.weight",
                          "side_tags", "hook_tags.weight"}


@pytest.mark.parametrize("shape", [(5,), (4, 3)], ids=["rows", "grid"])
def test_forward_and_gradients_match_jax(maps, shape):
    """Outputs [..., 7, d] within rtol 1e-5 / atol 1e-6; the gradient of
    sum(out * G) plus the embedding regularizer (l2 0.1, through each
    package's own regularization_loss) for every parameter and for the
    numeric values within rtol 1e-5 / atol 1e-6 of its scale. Frozen
    fields stop the gradient at the gathered vectors only: the frozen
    ``item`` rows and the frozen ``artist`` side table get the
    regularizer's gradient alone, 0.1 * w, as in JAX."""
    jfm, fm = maps
    X, Xf = _inputs(1, shape)
    G = np.random.RandomState(2).randn(*shape, 7, D).astype(np.float32)
    jemb = _jax_embedding(jfm)
    jp = jemb.init(jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(Xf))["params"]

    def jloss(p, xf):
        out = jemb.apply({"params": p}, jnp.asarray(X), xf)
        return jnp.sum(out * G) + jax_reg({"embedding_layer": p}, 0.1, 0), out

    (_, jout), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(Xf))

    emb = PackedEmbedding(EmbeddingSpec.build(fm, D), D, data_dir=fm.data_dir)
    emb.load_state_dict({k.split(".", 1)[1]: v for k, v in
                         params_from_jax({"embedding_layer": jp}).items()})
    xf = torch.from_numpy(Xf).requires_grad_()
    out = emb(torch.from_numpy(X).long(), xf)
    loss = (out * torch.from_numpy(G)).sum() + regularization_loss(
        [("embedding_layer." + n, w) for n, w in emb.named_parameters()], 0.1, 0)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)

    def close(got, want, name):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(want).max(), 1.0), err_msg=name)

    want = {k.split(".", 1)[1]: v for k, v in
            params_from_jax({"embedding_layer": jax.device_get(jg)}).items()}
    for name, w in emb.named_parameters():
        close(w.grad.numpy(), want[name].numpy(), name)
    close(xf.grad.numpy(), np.asarray(jgx), "X_numeric")
    item = emb.spec.pretrained["item"]
    rows = slice(item["offset"], item["offset"] + item["rows"])
    torch.testing.assert_close(emb.table.grad[rows], 0.1 * emb.table[rows].detach())
    torch.testing.assert_close(emb.side_artist.grad, 0.1 * emb.side_artist.detach())
    assert emb.side_tags.grad.abs().sum() > 0.2 * emb.side_tags.detach().abs().sum()


def test_model_with_every_field_kind_matches_jax(maps):
    """RATModel (RAT_m2, wide tower on, so the LR tower gets the numeric
    fields too) over the map: every embedding parameter, side tables
    and hooks included, is named under "embedding_layer" in both
    packages; logits within rtol 1e-5 / atol 1e-5; the loss gradient of
    every parameter within rtol 1e-5 / atol 1e-7 + 1e-6 of its scale."""
    jfm, fm = maps
    params = {"model": "RAT_m2", "embedding_dim": D, "dnn_hidden_units": [8], "num_heads": 2,
              "dim_head": 4, "depth": 1, "scale_dim": 2, "use_wide": True, "seed": 5}
    X, Xf = _inputs(3, (6, 3))
    y = np.random.RandomState(4).randint(0, 2, (6, 3)).astype(np.float32)
    jmodel = jbuild(jfm, params)
    jp = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(X), jnp.asarray(y),
                     jnp.asarray(Xf))["params"]

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xf))
        return jnp.mean(out["y_pred"]) + jax_reg(p, 0.1, 0.01), out["y_pred"]

    (_, jpred), jg = jax.value_and_grad(jloss, has_aux=True)(jp)

    model = build_model(fm, params)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    out = model(torch.from_numpy(X).long(), torch.from_numpy(y), torch.from_numpy(Xf))
    loss = out["y_pred"].mean() + regularization_loss(model.named_parameters(), 0.1, 0.01)
    loss.backward()
    np.testing.assert_allclose(out["y_pred"].detach().numpy(), np.asarray(jpred),
                               rtol=1e-5, atol=1e-5)
    want = params_from_jax(jax.device_get(jg))
    jax_emb = {"/".join(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jp)[0]
               if "embedding_layer" in "/".join(k.key for k in path)}
    assert {n for n, _ in model.named_parameters() if "embedding_layer" in n} == \
        set(params_from_jax({p: 0.0 for p in jax_emb}))
    for name, w in model.named_parameters():
        np.testing.assert_allclose(w.grad.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7 + 1e-6 * want[name].abs().max().item(),
                                   err_msg=name)
