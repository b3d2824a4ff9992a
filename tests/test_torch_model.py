"""RATModel (RAT_m2) and its fused fast path: the port against the JAX
package, from the same weights.

The flax params of ``rat_tpu.models.RATModel`` are carried across by
``params_from_jax``; the same seeded inputs go through
``RATModel.apply`` / JAX ``rat_m2_fast_forward(use_kernel=False)`` and
through the port's ``RATModel`` / ``rat_m2_fast_forward`` on the CPU.
Predictions agree within 1e-5 (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.features import FeatureMap as JFeatureMap
from rat_tpu.models import build_model as jbuild
from rat_tpu.models.fast_forward import rat_m2_fast_forward as jfast
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.models import build_model, rat_m2_fast_forward

TOL = dict(rtol=1e-5, atol=1e-5)


def _port_model(feature_map, params, jparams):
    fm = FeatureMap(feature_map.dataset_id, feature_map.data_dir)
    fm.from_dict(feature_map.to_dict())
    model = build_model(fm, params)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return model.eval()


def _inputs(seed, B, K, vocab_hi, L):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, vocab_hi, (B, 1 + K, L)).astype(np.int32)
    y = rng.randint(0, 2, (B, 1 + K)).astype(np.float32)
    return X, y


def _compare(jmodel, variables, model, X, y, nbr_mask=None):
    want = np.asarray(jmodel.apply(variables, jnp.asarray(X), jnp.asarray(y),
                                   train=False,
                                   nbr_mask=None if nbr_mask is None
                                   else jnp.asarray(nbr_mask))["y_pred"])
    Xt, yt = torch.from_numpy(X).long(), torch.from_numpy(y)
    with torch.no_grad():
        got = model(Xt, yt, nbr_mask=None if nbr_mask is None
                    else torch.from_numpy(nbr_mask))
    np.testing.assert_allclose(got["y_pred"].numpy(), want, **TOL)
    np.testing.assert_array_equal(got["y_true"].numpy(), y[:, :1])
    if nbr_mask is None:
        jf = np.asarray(jfast(variables["params"], jmodel, jnp.asarray(X),
                              jnp.asarray(y), use_kernel=False)["y_pred"])
        # the fused path is differentiable: score it as the Trainer does
        with torch.no_grad():
            fast = rat_m2_fast_forward(model, Xt, yt)["y_pred"].numpy()
        np.testing.assert_allclose(fast, jf, **TOL)
        np.testing.assert_allclose(fast, want, **TOL)


@pytest.mark.parametrize("over", [{"depth": 2},
                                  {"depth": 2, "num_heads": 1, "dim_head": 8}])
def test_model_and_fast_path_match_jax(tiny_feature_map, demo_params, over):
    """use_wide on, depth 2; the second case has heads=1, dim_head=d, so
    the JAX path feeds zero projections and the port skips them."""
    params = dict(demo_params, **over)
    jmodel = jbuild(tiny_feature_map, params)
    X, y = _inputs(0, 8, 3, 10, 3)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y),
                            train=False)
    model = _port_model(tiny_feature_map, params, variables["params"])
    _compare(jmodel, variables, model, X, y)


def test_nbr_mask_matches_jax(tiny_feature_map, demo_params):
    params = dict(demo_params, depth=2)
    jmodel = jbuild(tiny_feature_map, params)
    X, y = _inputs(1, 8, 3, 10, 3)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(X), jnp.asarray(y),
                            train=False)
    model = _port_model(tiny_feature_map, params, variables["params"])
    mask = np.random.RandomState(5).randint(0, 2, (8, 4)).astype(np.float32)
    mask[:, 0] = 1.0
    _compare(jmodel, variables, model, X, y, nbr_mask=mask)


def test_sequence_field_matches_jax(tmp_path, demo_params):
    """A KKBox-like map: two categorical fields and one 4-long sequence
    field (MaskedAveragePooling, padding id = vocab - 1)."""
    fm = JFeatureMap("kk", str(tmp_path))
    fm.feature_specs = {
        "user": {"type": "categorical", "vocab_size": 12, "index": 0},
        "genre": {"type": "sequence", "vocab_size": 9, "index": [1, 2, 3, 4],
                  "max_len": 4, "encoder": "MaskedAveragePooling"},
        "song": {"type": "categorical", "vocab_size": 10, "index": 5},
    }
    fm.num_fields, fm.num_features, fm.input_length = 3, 31, 6
    params = dict(demo_params, depth=2)
    jmodel = jbuild(fm, params)
    X, y = _inputs(2, 8, 3, 9, 6)
    X[:, :, 3:5] = 8                     # padded tail of the sequences
    X[0, :, 1:5] = 8                     # an all-padding sequence
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(y),
                            train=False)
    model = _port_model(fm, params, variables["params"])
    _compare(jmodel, variables, model, X, y)


def test_params_from_jax_names_and_layouts(tiny_feature_map, demo_params):
    params = dict(demo_params, depth=2)
    jmodel = jbuild(tiny_feature_map, params)
    X, y = _inputs(3, 2, 3, 10, 3)
    variables = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(X), jnp.asarray(y),
                            train=False)
    state = params_from_jax(jax.device_get(variables["params"]))
    model = build_model(tiny_feature_map, params)
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name
    emb = {n for n in state if "embedding_layer" in n}
    assert emb == {"embedding_layer.table", "label_embedding_layer.table",
                   "lr_layer.embedding_layer.table"}
    qkv = np.asarray(variables["params"]["encoder"]["CrossIntraEncoderBlock_1"]
                     ["cross_attention"]["Attention_0"]["to_qkv"]["kernel"])
    np.testing.assert_array_equal(
        state["encoder.blocks.1.cross_attention.attn.to_qkv.weight"].numpy(), qkv.T)
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in model.parameters())


def test_seeded_init_is_reproducible(tiny_feature_map, demo_params):
    a = build_model(tiny_feature_map, demo_params).state_dict()
    b = build_model(tiny_feature_map, demo_params).state_dict()
    c = build_model(tiny_feature_map, dict(demo_params, seed=7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embedding_layer.table"], c["embedding_layer.table"])
    assert np.isclose(a["label_embedding_layer.table"].std().item(), 1.0, atol=0.6)
