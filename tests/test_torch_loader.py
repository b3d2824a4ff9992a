"""The port's split loading and retrieval loops against the JAX
package's (rat_tpu.data.loader), exact, on seeded arrays: X-fold
self-retrieval, pool retrieval with label-wise sub-pools, the
train/valid generators of h5_generator, and the index batching."""

import os

import h5py
import numpy as np
import pytest

from rat_tpu.data import loader as jl
from rat_tpu_torch.data import loader as tl
from rat_tpu_torch.features import FeatureMap


def _rows(rng, n, vocab=(12, 9, 7)):
    X = np.stack([rng.randint(0, v, n) for v in vocab], axis=1)
    y = (rng.rand(n) < 0.4).astype(np.float64)
    return np.concatenate([X, y[:, None]], axis=1).astype(np.float64)


def _rc(**over):
    rc = {"used_cols": ["user_id", "item_id", "tag_id"],
          "used_col_indices": [0, 1, 2], "exact_match_cols": [],
          "exact_match_col_indices": None, "split_type": "10-fold",
          "label_wise": False, "pre_retrieval": True, "qry_batch_size": 50,
          "db_chunk_size": 128, "topK": 4}
    rc.update(over)
    return rc


@pytest.mark.parametrize("label_wise", [False, True])
def test_fold_self_retrieval_matches_jax(label_wise):
    data = _rows(np.random.RandomState(0), 403)
    want = jl._fold_self_retrieval(data, _rc(label_wise=label_wise))
    got = tl._fold_self_retrieval(data, _rc(label_wise=label_wise), device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("label_wise", [False, True])
def test_pool_retrieval_matches_jax(label_wise):
    rng = np.random.RandomState(1)
    pool, qry = _rows(rng, 500), _rows(rng, 77)
    want = jl._pool_retrieval(qry, pool, _rc(label_wise=label_wise))
    got = tl._pool_retrieval(qry, pool, _rc(label_wise=label_wise), device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_train_valid_generators_match_jax(tmp_path, tiny_feature_map):
    rng = np.random.RandomState(2)
    splits = {"train.h5": _rows(rng, 600), "valid.h5": _rows(rng, 130)}
    gens = {}
    for pkg, h5gen in (("jax", jl.h5_generator), ("torch", tl.h5_generator)):
        root = tmp_path / pkg
        os.makedirs(root)
        for name, arr in splits.items():
            with h5py.File(root / name, "w") as hf:
                hf.create_dataset("data", data=arr)
        fm = tiny_feature_map
        extra = {}
        if pkg == "torch":
            fm = FeatureMap(fm.dataset_id, fm.data_dir)
            fm.from_dict(tiny_feature_map.to_dict())
            extra = {"device": "cpu"}
        gens[pkg] = h5gen(fm, stage="train", train_data=str(root / "train.h5"),
                          valid_data=str(root / "valid.h5"), batch_size=64,
                          shuffle=False, retrieval_configs=_rc(),
                          retrieval_augmented=True, **extra)
    for jg, tg in zip(gens["jax"], gens["torch"]):
        for name in ("retr_indices", "retr_values", "retr_lens", "darray"):
            np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
        np.testing.assert_array_equal(tg.neighbor_gather_indices(),
                                      jg.neighbor_gather_indices())
        np.testing.assert_array_equal(tg.neighbor_valid_mask(),
                                      jg.neighbor_valid_mask())
        assert (tg.num_samples, tg.num_batches, tg.num_positives, tg.topk) == \
            (jg.num_samples, jg.num_batches, jg.num_positives, jg.topk)
        for (ti, tv), (ji, jv) in zip(tg.epoch_index_batches(),
                                      jg.epoch_index_batches()):
            np.testing.assert_array_equal(ti, ji)
            assert tv == jv


def test_in_memory_generator_equals_h5_generator(tmp_path):
    rng = np.random.RandomState(3)
    pool, test = _rows(rng, 300), _rows(rng, 90)
    for name, arr in (("pool.h5", pool), ("test.h5", test)):
        with h5py.File(tmp_path / name, "w") as hf:
            hf.create_dataset("data", data=arr)
    kw = dict(batch_size=32, retrieval_configs=_rc(), retrieval_augmented=True,
              device="cpu")
    a = tl.DataGenerator(data_path=str(tmp_path / "test.h5"),
                         retrieval_pool_fname=str(tmp_path / "pool.h5"), **kw)
    b = tl.DataGenerator(data_array=test, pool_array=pool,
                         retrieval_pool_fname="pool", **kw)
    for name in ("retr_indices", "retr_values", "retr_lens", "pool_darray"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # only the h5-backed generator writes a retrieval cache
    assert sorted(os.listdir(tmp_path)) == ["pool.h5", "retrieval_4_test.h5",
                                            "test.h5"]
