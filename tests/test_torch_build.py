"""The port's dataset build (rat_tpu_torch/data/build.py) against the JAX
package's under every split rule: a sequential and a seeded random
valid/test carve, a ``pool_ratio`` carve under a split type that is not
N-fold (and none under N-fold), an explicit pool file, and blocked
parts. Each must give a byte-identical ``feature_map.json`` and split
arrays equal to the JAX package's ``.h5`` datasets. Then the port's
synthetic generators against the JAX package's files."""

import os

import h5py
import numpy as np
import pandas as pd
import pytest

import rat_tpu.data.synthetic as jax_synthetic
import rat_tpu_torch.data.synthetic as synthetic
from rat_tpu.data.build import build_dataset as jax_build_dataset
from rat_tpu.data.build import split_train_test as jax_split_train_test
from rat_tpu.features import FeatureEncoder as JaxFeatureEncoder
from rat_tpu_torch.data import build_dataset, split_train_test
from rat_tpu_torch.features import FeatureEncoder, csv_table

COLS = [{"active": True, "dtype": "float", "name": ["user_id", "item_id", "tag_id"],
         "type": "categorical"}]
LABEL = {"dtype": "float", "name": "label"}


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("csv"))
    jax_synthetic.make_mltag_like(out, n_train=2400, n_valid=300, n_test=300,
                                  n_users=150, n_items=90, n_tags=30, seed=8)
    # an explicit retrieval pool file of the same schema
    jax_synthetic.make_mltag_like(out + "/pool", n_train=900, n_valid=1, n_test=1,
                                  n_users=170, n_items=90, n_tags=30, seed=9)
    return out


def _build(tmp_path, csv_dir, seed=7, **extra):
    """(JAX data dir, port data dir) after building the same params."""
    params = dict({"dataset_id": "mltag_b", "feature_cols": COLS, "label_col": LABEL,
                   "min_categr_count": 1, "train_data": csv_dir + "/train.csv"}, **extra)
    dirs = []
    for pkg, Enc, build in (("jax", JaxFeatureEncoder, jax_build_dataset),
                            ("torch", FeatureEncoder, build_dataset)):
        p = dict(params, data_root=str(tmp_path / pkg))
        enc = Enc(**p)
        np.random.seed(seed)
        build(enc, **p)
        dirs.append(enc.data_dir)
    return dirs


def _assert_same(jax_dir, torch_dir):
    with open(os.path.join(jax_dir, "feature_map.json"), "rb") as a, \
            open(os.path.join(torch_dir, "feature_map.json"), "rb") as b:
        assert a.read() == b.read()
    names = sorted(f[:-3] for f in os.listdir(jax_dir) if f.endswith(".h5"))
    assert sorted(f[:-4] for f in os.listdir(torch_dir) if f.endswith(".npy")) == names
    for name in names:
        with h5py.File(os.path.join(jax_dir, name + ".h5"), "r") as hf:
            assert np.array_equal(np.load(os.path.join(torch_dir, name + ".npy")),
                                  hf["data"][()]), name
    return names


@pytest.mark.parametrize("split_type", ["sequential", "random"])
@pytest.mark.parametrize("sizes", [(0.1, 0.2), (300, 0), (0, 0.25)])
def test_valid_test_carve_matches_jax(tmp_path, csv_dir, split_type, sizes):
    valid_size, test_size = sizes
    names = _assert_same(*_build(tmp_path, csv_dir, valid_size=valid_size,
                                 test_size=test_size, split_type=split_type))
    want = ["train"] + (["valid"] if valid_size else []) + (["test"] if test_size else [])
    assert names == sorted(want)


def test_random_carve_follows_the_seeded_global_rng(tmp_path, csv_dir):
    a = _build(tmp_path / "a", csv_dir, seed=1, valid_size=0.2, split_type="random")
    b = _build(tmp_path / "b", csv_dir, seed=2, valid_size=0.2, split_type="random")
    assert not np.array_equal(np.load(a[1] + "/valid.npy"), np.load(b[1] + "/valid.npy"))


@pytest.mark.parametrize("pool_split", ["sequential", "random"])
def test_pool_ratio_carve_matches_jax(tmp_path, csv_dir, pool_split):
    rc = {"split_type": pool_split, "pool_ratio": 0.3}
    names = _assert_same(*_build(tmp_path, csv_dir, valid_data=csv_dir + "/valid.csv",
                                 retrieval_configs=rc))
    assert names == ["retrieval_pool", "train", "valid"]


def test_fold_split_writes_no_pool(tmp_path, csv_dir):
    rc = {"split_type": "10-fold", "pool_ratio": 0.2}
    names = _assert_same(*_build(tmp_path, csv_dir, test_data=csv_dir + "/test.csv",
                                 retrieval_configs=rc))
    assert names == ["test", "train"]


def test_explicit_pool_file_matches_jax(tmp_path, csv_dir):
    """The encoder is fit on train + pool: the pool's extra users get
    vocabulary ids."""
    rc = {"split_type": "sequential", "retrieval_pool_data": csv_dir + "/pool/train.csv"}
    jdir, tdir = _build(tmp_path, csv_dir, valid_data=csv_dir + "/valid.csv",
                        retrieval_configs=rc)
    assert _assert_same(jdir, tdir) == ["retrieval_pool", "train", "valid"]
    assert np.load(tdir + "/retrieval_pool.npy")[:, 0].max() >= 150


def test_blocked_parts_match_jax(tmp_path, csv_dir):
    names = _assert_same(*_build(tmp_path, csv_dir, data_block_size=1000,
                                 test_data=csv_dir + "/test.csv"))
    assert names == ["test_part_0", "train_part_0", "train_part_1", "train_part_2"]


def test_split_train_test_tables_match_pandas(csv_dir):
    dtypes = dict.fromkeys(["user_id", "item_id", "tag_id", "label"], float)
    df = pd.read_csv(csv_dir + "/train.csv", dtype=dtypes)
    table = csv_table.read_csv(csv_dir + "/train.csv", dtypes)
    np.random.seed(3)
    want = jax_split_train_test(df, valid_size=0.1, test_size=77, split_type="random")
    np.random.seed(3)
    got = split_train_test(table, valid_size=0.1, test_size=77, split_type="random")
    for g, w in zip(got, want):
        assert list(g) == list(w.columns)
        for name in w.columns:
            np.testing.assert_array_equal(g[name], w[name].to_numpy())


@pytest.mark.parametrize("maker,kwargs,dtypes", [
    ("make_mltag_like", dict(n_train=500, n_valid=120, n_test=80, seed=3),
     dict.fromkeys(["user_id", "item_id", "tag_id", "label"], float)),
    ("make_kkbox_like", dict(n_train=400, n_valid=50, n_test=50, n_genres=9, seed=5),
     dict(dict.fromkeys(["msno", "song_id", "label"], float), genre_ids=str)),
])
def test_synthetic_csvs_read_back_like_jax(tmp_path, maker, kwargs, dtypes):
    getattr(jax_synthetic, maker)(str(tmp_path / "jax"), **kwargs)
    getattr(synthetic, maker)(str(tmp_path / "torch"), **kwargs)
    for split in ("train", "valid", "test"):
        want = pd.read_csv(tmp_path / "jax" / (split + ".csv"), dtype=dtypes)
        got = csv_table.read_csv(str(tmp_path / "torch" / (split + ".csv")), dtypes)
        assert list(got) == list(want.columns)
        for name in want.columns:
            np.testing.assert_array_equal(got[name], want[name].to_numpy(), err_msg=name)


def test_tmall_like_csvs_read_back_like_jax(tmp_path):
    kw = dict(n_train=700, n_test=300, n_pool=500, n_users=50, n_items=80, n_cats=7,
              n_sellers=11, n_brands=13, seed=4, chunk_rows=256)
    jax_synthetic.make_tmall_like(str(tmp_path / "jax"), **kw)
    synthetic.make_tmall_like(str(tmp_path / "torch"), **kw)
    for name in ("train.csv", "test.csv", "retrieval_pool.csv"):
        want = pd.read_csv(tmp_path / "jax" / name)
        got = csv_table.read_csv(str(tmp_path / "torch" / name),
                                 {col: int for col in want.columns})
        assert list(got) == list(want.columns)
        for col in want.columns:
            np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
