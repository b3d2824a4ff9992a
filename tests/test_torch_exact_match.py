"""Exact-match retrieval (rat_tpu_torch/retrieval/bm25.py) against the JAX
package's (rat_tpu.retrieval.bm25._exact_match_retrieval), exactly:
values, indices and lens, on seeded pools, on the CPU.

The cases follow tests/test_bm25.py: heavy ties, windows shorter and
longer than K and longer than one 4096-row pass, unmatched queries, no
other column (the flat branch and its truncation), 1 and 3+ other
columns, each at two query batch sizes (the flat branch is decided per
batch); an empty pool; a _retrieve cut into resume slices; the guards;
and DataGenerators with ``exact_match_cols`` on ``.h5`` splits written
by the JAX package's build. Then chip_smoke's exact_match phase runs as
a function at a small size."""

import os
import shutil

import numpy as np
import pytest

import chip_smoke
import rat_tpu.data.loader as jax_loader
import rat_tpu.data.synthetic as jax_synthetic
import rat_tpu_torch.data.loader as loader
from rat_tpu.data.build import build_dataset as jax_build_dataset
from rat_tpu.features import FeatureEncoder as JaxFeatureEncoder
from rat_tpu.features import FeatureMap as JaxFeatureMap
from rat_tpu.retrieval import bm25_topk_retrieval as jax_retrieval
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.retrieval import bm25_topk_retrieval


def _case(seed, n_pool, n_qry, vocabs, key_vocab=None, zipf=False):
    """(pool, queries) int64: each column uniform over its vocabulary (the
    first Zipf-like over ``key_vocab`` with ``zipf``); half the queries
    are pool rows, half random with values the pool may lack."""
    rng = np.random.RandomState(seed)
    pool = np.stack([rng.randint(0, v, n_pool) for v in vocabs], axis=1)
    if zipf:
        p = 1.0 / np.arange(1, key_vocab + 1) ** 1.3
        pool[:, 0] = rng.choice(key_vocab, n_pool, p=p / p.sum())
    qry = np.concatenate([pool[rng.randint(0, n_pool, n_qry // 2)],
                          np.stack([rng.randint(0, v + 2, n_qry - n_qry // 2)
                                    for v in vocabs], axis=1)])
    return pool.astype(np.int64), qry.astype(np.int64)


# name: (pool rows, queries, column vocabularies, exact columns, K,
# Zipf key vocabulary or None)
CASES = {
    "heavy_ties": (400, 60, (3, 3, 3, 3), [0], 6, None),
    "two_exact_cols": (400, 30, (3, 3, 3, 3, 3), [1, 3], 6, None),
    "short_and_long_windows": (3000, 90, (40, 7, 9), [0], 5, 40),
    "windows_above_one_pass": (12000, 40, (2, 5, 6), [0], 5, None),
    "unmatched_queries": (300, 50, (400, 4, 4), [0], 4, None),
    "no_other_column": (200, 40, (3, 3), [0, 1], 4, None),
    "no_other_column_short": (500, 40, (40, 30), [0, 1], 3, None),
    "one_other_column": (500, 40, (20, 4), [0], 5, None),
    "four_other_columns": (900, 70, (5, 4, 4, 3, 6), [0], 5, None),
    "k_above_windows": (60, 30, (12, 5, 5), [0], 10, None),
}


def _assert_equal(got, want):
    for name, a, b in zip(("values", "indices", "lens"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("batch", [None, 7], ids=["one_batch", "batches_of_7"])
@pytest.mark.parametrize("case", list(CASES))
def test_exact_match_matches_jax(case, batch):
    n_pool, n_qry, vocabs, exact, K, zipf = CASES[case]
    pool, qry = _case(len(case), n_pool, n_qry, vocabs, zipf, zipf is not None)
    kw = dict(exact_match_col_indices=exact, qry_batch_size=batch, topK=K)
    launches = k2.launches
    got = bm25_topk_retrieval(pool, qry, device="cpu", **kw)
    assert k2.launches == launches
    want = jax_retrieval(pool, qry, **kw)
    _assert_equal(got, want)
    if case == "unmatched_queries":
        assert (got.lens > 0).any() and (got.lens == 0).any()
    if case == "windows_above_one_pass":
        assert np.bincount(pool[:, 0]).max() > 4096
    if case.startswith("no_other_column"):
        # flat: value 1.0 in pool order, the last K of a longer window
        kept = got.indices >= 0
        assert (got.values[kept] == 1.0).all()
        rows = np.nonzero((pool == qry[0]).all(1))[0]
        np.testing.assert_array_equal(got.indices[0][:got.lens[0]], rows[-K:])


def test_empty_pool_matches_nothing():
    """A label-wise sub-pool can be empty (rat_tpu/retrieval/bm25.py:601)."""
    qry = np.random.RandomState(0).randint(0, 4, (4, 3))
    for fn, kw in ((bm25_topk_retrieval, {"device": "cpu"}), (jax_retrieval, {})):
        res = fn(np.zeros((0, 3), np.int64), qry, exact_match_col_indices=[0], topK=3,
                 **kw)
        assert (res.lens == 0).all() and (res.indices == -1).all()
        assert (res.values == 0).all()


@pytest.mark.parametrize("exact", [None, [0]], ids=["scan", "exact_match"])
def test_empty_label_wise_sub_pool_matches_nothing(exact):
    """A pool of positives only: the negative sub-pool is empty and
    matches nothing (indices -1, lens 0), and the positive half equals
    the JAX package's retrieval against the whole pool. (The JAX
    loader's own lookup of an empty sub-pool fails; ROADMAP.md Queue 3.)"""
    rng = np.random.RandomState(6)
    pool = np.concatenate([rng.randint(0, 5, (50, 3)), np.ones((50, 1))], axis=1)
    qry = np.concatenate([rng.randint(0, 5, (10, 3)), np.ones((10, 1))], axis=1)
    rc = {"used_col_indices": [0, 1, 2], "exact_match_col_indices": exact,
          "label_wise": True, "qry_batch_size": 4, "topK": 3}
    idx, vals, lens = loader._pool_retrieval(qry, pool, dict(rc), device="cpu")
    want = jax_loader._pool_retrieval(qry, pool, dict(rc, label_wise=False))
    for got, w in zip((idx[:, :3], vals[:, :3], lens[:, 0]), want):
        np.testing.assert_array_equal(got, w)
    assert (idx[:, 3:] == -1).all() and (vals[:, 3:] == 0).all() and (lens[:, 1] == 0).all()


def test_guards():
    pool, qry = _case(0, 50, 5, (3, 3, 3))
    with pytest.raises(ValueError, match="generation 1"):
        bm25_topk_retrieval(pool, qry, exact_match_col_indices=[0], generation=1,
                            device="cpu")
    with pytest.raises(ValueError, match="idf_tables"):
        bm25_topk_retrieval(pool, qry, exact_match_col_indices=[0], device="cpu",
                            idf_tables=[(np.arange(3), np.ones(3, np.float32))] * 2)


def test_exact_match_ignores_the_idf_choice():
    """Exact match scores with the lucene IDF whatever ``idf_weighting``
    says, as the JAX package does."""
    pool, qry = _case(5, 600, 40, (8, 5, 5))
    kw = dict(exact_match_col_indices=[0], qry_batch_size=16, topK=5)
    lucene = bm25_topk_retrieval(pool, qry, device="cpu", **kw)
    robertson = bm25_topk_retrieval(pool, qry, device="cpu", idf_weighting="robertson",
                                    **kw)
    _assert_equal(robertson, lucene)
    _assert_equal(robertson, jax_retrieval(pool, qry, idf_weighting="robertson", **kw))


@pytest.mark.parametrize("slice_rows", [37, 100])
def test_retrieve_in_resume_slices_matches_jax(tmp_path, slice_rows):
    """_retrieve cut into resume slices: batches are cut from each
    slice's first row, as the JAX package cuts them."""
    pool, qry = _case(3, 2000, 230, (30, 6, 6), 30, True)
    rc = {"exact_match_col_indices": [0], "qry_batch_size": 16, "topK": 5,
          "resume_slice_rows": slice_rows}
    got = loader._retrieve(pool, qry, dict(rc, resume_base=str(tmp_path / "t.npz")),
                           resume_tag="fold0", device="cpu")
    want = jax_loader._retrieve(pool, qry, dict(rc, resume_base=str(tmp_path / "j.h5")),
                                resume_tag="fold0")
    _assert_equal(got, want)


@pytest.fixture(scope="module")
def jax_h5_splits(tmp_path_factory):
    """feature_map.json and train/valid ``.h5`` splits of small ML-Tag-
    shaped CSVs, built by the JAX package."""
    root = tmp_path_factory.mktemp("exm")
    jax_synthetic.make_mltag_like(str(root / "csv"), n_train=1500, n_valid=300, n_test=10,
                                  n_users=30, n_items=40, n_tags=15, seed=4)
    params = {"dataset_id": "exm", "data_root": str(root / "data"),
              "feature_cols": [{"active": True, "dtype": "float", "type": "categorical",
                                "name": ["user_id", "item_id", "tag_id"]}],
              "label_col": {"dtype": "float", "name": "label"}, "min_categr_count": 1,
              "train_data": str(root / "csv" / "train.csv"),
              "valid_data": str(root / "csv" / "valid.csv")}
    enc = JaxFeatureEncoder(**params)
    jax_build_dataset(enc, **params)
    return enc.data_dir


@pytest.mark.parametrize("label_wise", [False, True])
def test_generators_with_exact_match_cols_match_jax(tmp_path, jax_h5_splits, label_wise):
    rc = {"used_cols": ["user_id", "item_id", "tag_id"], "exact_match_cols": ["user_id"],
          "split_type": "5-fold", "label_wise": label_wise, "pre_retrieval": True,
          "qry_batch_size": 64, "db_chunk_size": 500, "topK": 4}
    gens = {}
    for pkg, h5gen, fm_cls, extra in (("jax", jax_loader.h5_generator, JaxFeatureMap, {}),
                                      ("torch", loader.h5_generator, FeatureMap,
                                       {"device": "cpu"})):
        data_dir = str(tmp_path / pkg)
        shutil.copytree(jax_h5_splits, data_dir)
        fm = fm_cls("exm", data_dir)
        fm.load(os.path.join(data_dir, "feature_map.json"))
        gens[pkg] = h5gen(fm, stage="train", train_data=os.path.join(data_dir, "train*.h5"),
                          valid_data=os.path.join(data_dir, "valid*.h5"), batch_size=64,
                          retrieval_configs=dict(rc), retrieval_augmented=not label_wise,
                          **extra)
    for gen, jgen in zip(gens["torch"], gens["jax"]):
        for name in ("num_samples", "num_positives"):
            assert getattr(gen, name) == getattr(jgen, name)
        if not label_wise:
            for name in ("retr_indices", "retr_values", "retr_lens"):
                np.testing.assert_array_equal(getattr(gen, name), getattr(jgen, name))
    # the caches each package wrote beside its .h5 splits are equal
    for split in ("train", "valid"):
        name = "retrieval_4_{}.h5".format(split)
        for key in ("indices", "values", "lens"):
            got = loader.load_array(str(tmp_path / "torch" / name), key)
            np.testing.assert_array_equal(
                got, loader.load_array(str(tmp_path / "jax" / name), key))
        assert (got > 0).any() and got.shape[-1] == 2 if label_wise else 1


def test_chip_smoke_exact_match_phase_on_cpu():
    vocab = {"user_id": 60, "item_id": 80, "tag_id": 120}
    pool, test = chip_smoke.mltag_arrays(0, 20000, 11000, vocab=vocab)
    upool, utest = chip_smoke.mltag_arrays(1, 20000, 11000, vocab=vocab, zipf_a=0.0)
    before = k2.launches
    out = chip_smoke.exact_match("cpu", 0, pool, test, upool, utest)
    assert k2.launches == before
    assert out["zipf_user_exact"]["scored_batches"] == 3
    assert out["zipf_user_exact"]["largest_window"] > 4096
    assert out["all_exact"]["flat_batches"] == 3 and out["all_exact"]["scored_batches"] == 0
    assert out["all_exact"]["largest_window"] > 5
    assert 200 < out["uniform_user_exact"]["mean_window"] < 500
