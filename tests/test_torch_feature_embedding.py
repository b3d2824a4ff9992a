"""The port's FuxiCTR-v2 feature embedding (rat_tpu_torch.nn.
feature_embedding) against the JAX package's on seeded ids on the CPU:
the encoder parser's accepted forms and rejections, the dict and tensor
views, per-field dims (dynamic_emb_dim), the column and call-time
filters, the LR fallback, sharing, numeric and frozen pretrained fields,
and the encoder chains (masked average and sum pooling, KMaxPooling with
its right-anchored axis and the ties of padding rows, Linear) on a row
[B, L] and on the retrieval grid [B, 1+K, L]. Outputs within rtol 1e-5
/ atol 1e-6, the tables' and encoders' gradients within rtol 1e-4 /
atol 1e-5 (each atol at the scale of the largest value where it is
above 1, torch_layer_parity.compare)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.features import FeatureMap
from rat_tpu.nn import feature_embedding as jfe
from rat_tpu_torch.nn import feature_embedding as tfe
from torch_layer_parity import compare, one_thread  # noqa: F401


def _fm(specs):
    fm = FeatureMap("t", ".")
    fm.feature_specs.update(specs)
    fm.num_fields = len(specs)
    fm.input_length = sum(len(s["index"]) if isinstance(s["index"], list) else 1
                          for s in specs.values())
    return fm


def _specs(tags_encoder="layers.MaskedAveragePooling()"):
    return {
        "u": {"source": "user", "type": "categorical", "vocab_size": 9, "index": 0},
        "i": {"source": "item", "type": "categorical", "vocab_size": 7, "index": 1,
              "padding_idx": 0},
        "tags": {"source": "item", "type": "sequence", "vocab_size": 6,
                 "index": [2, 3, 4, 5], "padding_idx": 5,
                 "feature_encoder": tags_encoder},
    }


def _ids(seed, lead, specs):
    """Ids over each field's vocabulary; sequences padded (vocab - 1)
    after 1 to all of their positions."""
    rng = np.random.RandomState(seed)
    cols = []
    for spec in specs.values():
        if spec["type"] == "numeric":
            cols.append(np.zeros(lead + (1,), np.int64))
            continue
        width = len(spec["index"]) if spec["type"] == "sequence" else 1
        ids = rng.randint(0, spec["vocab_size"] - 1, lead + (width,))
        if spec["type"] == "sequence":
            n = rng.randint(1, width + 1, lead + (1,))
            ids[np.arange(width) >= n] = spec["vocab_size"] - 1
        cols.append(ids)
    return np.concatenate(cols, axis=-1).astype(np.int32)


PARSE = [("layers.MaskedAveragePooling()", ("MaskedAveragePooling", (), {})),
         ("nn.Linear(64, 10, bias=False)", ("Linear", (64, 10), {"bias": False})),
         ("layers.KMaxPooling(2, dim=1)", ("KMaxPooling", (2,), {"dim": 1})),
         ("MaskedSumPooling()", ("MaskedSumPooling", (), {}))]


@pytest.mark.parametrize("expr,want", PARSE)
def test_parse_feature_encoder_accepts_reference_forms(expr, want):
    assert tfe.parse_feature_encoder(expr) == want == jfe.parse_feature_encoder(expr)


@pytest.mark.parametrize("bad", ["__import__('os').system('true')",
                                 "layers.MaskedAveragePooling", "eval('1+1')",
                                 "nn.Linear(64, open('/etc/passwd'))", "SomethingElse()",
                                 "nn.Linear(4,"])
def test_parse_feature_encoder_rejects(bad):
    """The rejections of tests/test_feature_embedding.py, and a syntax
    error."""
    for parse in (tfe.parse_feature_encoder, jfe.parse_feature_encoder):
        with pytest.raises(ValueError):
            parse(bad)


CASES = {
    "average": dict(specs=_specs()),
    "sum_grid": dict(specs=_specs("layers.MaskedSumPooling()"), lead=(5, 3)),
    "kmax_linear": dict(specs=_specs(["layers.KMaxPooling(2, dim=1)",
                                      "nn.Linear(4, 3, bias=False)"])),
    "kmax_grid_ties": dict(specs=_specs(["layers.KMaxPooling(3, dim=1)",
                                         "nn.Linear(4, 5)"]), lead=(5, 3)),
    "kmax_kwarg_linear_out": dict(specs=_specs(["layers.KMaxPooling(k=2)",
                                                "nn.Linear(4, out_features=2)"])),
    "unpooled": dict(specs=dict(_specs(), tags={**_specs()["tags"],
                                                "feature_encoder": None,
                                                "encoder": None})),
    "dims": dict(specs=dict(_specs(), u={**_specs()["u"], "embedding_dim": 6}),
                 kw=dict(dynamic_emb_dim=True), tensor=True),
    "filters": dict(specs=_specs(), kw=dict(feature_source="item",
                                            feature_type="categorical")),
    "required": dict(specs=_specs(), init=dict(required_feature_columns=("u", "tags"))),
    "not_required": dict(specs=_specs(), init=dict(not_required_feature_columns=("i",))),
    "lr_mode": dict(specs=_specs(), init=dict(use_pretrain=False), dim=1),
    "no_sharing": dict(specs=dict(_specs(), i={**_specs()["i"], "share_embedding": "u",
                                               "vocab_size": 9}),
                       init=dict(use_sharing=False)),
    "sharing": dict(specs=dict(_specs(), i={**_specs()["i"], "share_embedding": "u",
                                            "vocab_size": 9})),
    "std": dict(specs=_specs(), init=dict(embedding_initializer=0.1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_feature_embedding_matches_jax(case):
    """The dict view (or, with ``tensor``, FeatureEmbedding's tensor),
    with the gradients of every table and Linear encoder."""
    c = CASES[case]
    fm = _fm(c["specs"])
    dim, init = c.get("dim", 4), c.get("init", {})
    X = _ids(1, c.get("lead", (6,)), c["specs"])
    if c.get("tensor"):
        jm, tm = jfe.FeatureEmbedding(fm, dim, **init), tfe.FeatureEmbedding(fm, dim, **init)
    else:
        jm, tm = jfe.FeatureEmbeddingDict(fm, dim, **init), \
            tfe.FeatureEmbeddingDict(fm, dim, **init)
    out = compare(jm, tm, [X], kw=c.get("kw"), grads=True)
    if case == "kmax_grid_ties":
        assert out["tags"].shape == (5, 3, 3, 5)
    if case == "filters":
        assert list(out) == ["i"]


def test_numeric_and_frozen_pretrained_fields(tmp_path):
    """A numeric field (value x its weight vector) and a frozen
    pretrained field of the model's width: its rows are loaded from the
    h5 file and get no gradient from the lookup."""
    import h5py
    rng = np.random.RandomState(2)
    with h5py.File(tmp_path / "pre.h5", "w") as hf:
        hf.create_dataset("i", data=rng.randn(7, 4).astype(np.float32))
    specs = dict(_specs(), price={"source": "", "type": "numeric", "index": 6})
    specs["i"] = dict(specs["i"], pretrained_emb="pre.h5", freeze_emb=True)
    fm = _fm(specs)
    X = _ids(3, (6,), specs)
    Xn = np.zeros(X.shape, np.float32)
    Xn[:, 6] = rng.rand(6)
    init = dict(data_dir=str(tmp_path))
    out = compare(jfe.FeatureEmbeddingDict(fm, 4, **init),
                  tfe.FeatureEmbeddingDict(fm, 4, **init), [X, Xn], grads=True)
    assert out["price"].shape == (6, 4)


def test_kmax_pooling_positive_dim_anchors_from_right():
    """dim=1 in a config's [B, L, D] convention is the sequence axis -2
    of a [B, 1+K, L, D] span, as in the JAX module."""
    emb = np.random.RandomState(0).randn(2, 3, 5, 4).astype(np.float32)
    mod = tfe.FeatureEmbeddingDict(_fm(_specs()), 4)
    got = mod._apply_encoder(torch.from_numpy(emb), ("KMaxPooling", (), {"k": 2, "dim": 1}),
                             "enc")
    want = jfe.FeatureEmbeddingDict.__new__(jfe.FeatureEmbeddingDict)._apply_encoder(
        jnp.asarray(emb), ("KMaxPooling", (), {"k": 2, "dim": 1}), "enc")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 3, 2, 4)


def test_dict2tensor_views():
    fm = _fm(_specs())
    layer = tfe.FeatureEmbeddingDict(fm, 4, generator=torch.Generator().manual_seed(0))
    out = layer(torch.from_numpy(_ids(4, (2,), _specs()).astype(np.int64)))
    stacked = layer.dict2tensor(out)
    assert stacked.shape == (2, 3, 4)
    flat = layer.dict2tensor(out, dynamic_emb_dim=True)
    torch.testing.assert_close(stacked.reshape(2, 12), flat, rtol=0, atol=0)
    assert layer.dict2tensor(out, feature_source="item").shape == (2, 2, 4)

