"""The port's FeatureEncoder and dataset hooks against the JAX package's,
on the same CSVs: ``feature_map.json`` byte for byte and every encoded
split array equal to the JAX package's ``.h5`` dataset, for ML-Tag- and
KKBox-shaped data from the JAX package's generators and for a
hand-written KKBox-schema CSV with the ``isrc``/``bd`` hooks and missing
cells; then the hooks themselves and the pickled encoder."""

import os

import h5py
import numpy as np
import pandas as pd
import pytest

import rat_tpu.features.datasets as jax_datasets
from rat_tpu.data.build import build_dataset as jax_build_dataset
from rat_tpu.data.synthetic import make_kkbox_like as jax_make_kkbox_like
from rat_tpu.data.synthetic import make_mltag_like as jax_make_mltag_like
from rat_tpu.features import FeatureEncoder as JaxFeatureEncoder
from rat_tpu_torch.data import build_dataset
from rat_tpu_torch.features import FeatureEncoder
from rat_tpu_torch.features import datasets

MLTAG_COLS = [{"active": True, "dtype": "float", "name": ["user_id", "item_id", "tag_id"],
               "type": "categorical"}]
LABEL = {"dtype": "float", "name": "label"}


def _encoder(module, params):
    name = params["dataset_id"].split("_")[0]
    if hasattr(module, name):
        return getattr(module, name).FeatureEncoder(**params)
    return (FeatureEncoder if module is datasets else JaxFeatureEncoder)(**params)


def build_both(tmp_path, params):
    """Build with each package under its own data_root; returns (JAX
    data dir, port data dir)."""
    dirs = []
    for pkg, build, module in (("jax", jax_build_dataset, jax_datasets),
                               ("torch", build_dataset, datasets)):
        p = dict(params, data_root=str(tmp_path / pkg))
        enc = _encoder(module, p)
        build(enc, **p)
        dirs.append(enc.data_dir)
    return dirs


def assert_same_build(jax_dir, torch_dir):
    with open(os.path.join(jax_dir, "feature_map.json"), "rb") as fh:
        want = fh.read()
    with open(os.path.join(torch_dir, "feature_map.json"), "rb") as fh:
        assert fh.read() == want
    splits = sorted(f[:-3] for f in os.listdir(jax_dir) if f.endswith(".h5"))
    assert splits and sorted(f[:-4] for f in os.listdir(torch_dir)
                             if f.endswith(".npy")) == splits
    for split in splits:
        with h5py.File(os.path.join(jax_dir, split + ".h5"), "r") as hf:
            ref = hf["data"][()]
        got = np.load(os.path.join(torch_dir, split + ".npy"))
        assert got.dtype == ref.dtype and got.shape == ref.shape, split
        assert np.array_equal(got, ref), split
    return splits


def test_mltag_csvs_build_like_jax(tmp_path):
    csv = str(tmp_path / "csv")
    jax_make_mltag_like(csv, n_train=3000, n_valid=700, n_test=500, n_users=300,
                        n_items=120, n_tags=40, seed=4)
    params = {"dataset_id": "mltag_tiny", "feature_cols": MLTAG_COLS, "label_col": LABEL,
              "min_categr_count": 2, "train_data": csv + "/train.csv",
              "valid_data": csv + "/valid.csv", "test_data": csv + "/test.csv"}
    assert assert_same_build(*build_both(tmp_path, params)) == ["test", "train", "valid"]


def test_kkbox_like_csvs_with_a_sequence_field_build_like_jax(tmp_path):
    csv = str(tmp_path / "csv")
    jax_make_kkbox_like(csv, n_train=2000, n_valid=400, n_test=400, n_users=90,
                        n_songs=70, n_genres=12, seed=2)
    params = {"dataset_id": "kk_tiny", "label_col": LABEL, "min_categr_count": 1,
              "feature_cols": [
                  {"active": True, "dtype": "float", "name": ["msno", "song_id"],
                   "type": "categorical"},
                  {"active": True, "dtype": "str", "name": "genre_ids", "type": "sequence",
                   "encoder": "MaskedAveragePooling", "max_len": 3, "splitter": "|"},
                  {"active": True, "dtype": "str", "name": "genre_all", "type": "sequence",
                   "splitter": "|", "share_embedding": "genre_ids", "padding": "pre"}],
              "train_data": csv + "/train.csv", "valid_data": csv + "/valid.csv",
              "test_data": csv + "/test.csv"}
    for split in ("train", "valid", "test"):   # a second sequence column
        df = pd.read_csv(os.path.join(csv, split + ".csv"))
        df["genre_all"] = df["genre_ids"]
        df.to_csv(os.path.join(csv, split + ".csv"), index=False)
    assert assert_same_build(*build_both(tmp_path, params)) == ["test", "train", "valid"]


KKBOX_SCHEMA = """msno,song_id,source_type,genre_ids,isrc,bd,score,label
u1,s1,radio,465|958,USABC1234,25,0.5,1
u2,s2,,465,,NA,1.5,0
u1,s3,NA,958,GBXYZ,null,,1
u3,s1,radio,,nan,0,2.5,0
u2,s2,online,465|1609|958,USQQQ,96,NA,1
u1,s1,online,nan,JP000,44,0.25,0
u4,s4,radio,1609,USABC,17,3.0,1
u2,s3,null,958|465,"FR,01",60,1.0,0
u3,s2,online,465,GB111,61,nan,1
u1,s1,radio,958,US222,abc,0.75,0
"""


def test_hand_written_kkbox_schema_with_hooks_and_missing_cells(tmp_path):
    """Missing cells ("", "NA", "nan", "null") in str and float columns:
    str columns fill with "", the float column with its na_value; the
    isrc/bd hooks of the KKBox encoder; numeric and sequence fields."""
    csv = tmp_path / "csv"
    csv.mkdir()
    for split, rows in (("train", slice(0, None)), ("valid", slice(0, 6))):
        lines = KKBOX_SCHEMA.strip().split("\n")
        (csv / (split + ".csv")).write_text("\n".join(lines[:1] + lines[1:][rows]) + "\n")
    params = {"dataset_id": "kkbox_schema", "label_col": LABEL, "min_categr_count": 1,
              "feature_cols": [
                  {"active": True, "dtype": "str", "name": ["msno", "song_id", "source_type"],
                   "type": "categorical"},
                  {"active": True, "dtype": "str", "encoder": "MaskedSumPooling",
                   "max_len": 3, "name": "genre_ids", "type": "sequence", "splitter": "|"},
                  {"active": True, "dtype": "str", "name": "isrc",
                   "preprocess": "extract_country_code", "type": "categorical"},
                  {"active": True, "dtype": "str", "name": "bd",
                   "preprocess": "bucketize_age", "type": "categorical"},
                  {"active": True, "dtype": "float", "name": "score", "type": "numeric",
                   "na_value": 0, "normalizer": "StandardScaler"}],
              "train_data": str(csv / "train.csv"), "valid_data": str(csv / "valid.csv")}
    jdir, tdir = build_both(tmp_path, params)
    assert assert_same_build(jdir, tdir) == ["train", "valid"]
    # without a na_value a float column with missing cells is an error
    bad = dict(params, dataset_id="kkbox_bad", feature_cols=params["feature_cols"][:-1]
               + [dict(params["feature_cols"][-1], na_value=None)])
    with pytest.raises(RuntimeError, match="na_value"):
        build_dataset(datasets.kkbox.FeatureEncoder(**dict(bad, data_root=str(tmp_path))),
                      **bad)


def test_kkbox_and_tmall_hooks_match_jax():
    ages = ["5", "10", "11", "20", "21", "35", "60", "61", "95", "96", "0", None,
            "", "abc", "1e1", " 30"]
    isrc = ["USABC123", None, "GBXYZ", "", "J"] + ["X"] * 11
    df = pd.DataFrame({"age": ages, "isrc": isrc})
    table = {"age": np.array(ages, dtype=object), "isrc": np.array(isrc, dtype=object)}
    jkk = jax_datasets.kkbox.FeatureEncoder.__new__(jax_datasets.kkbox.FeatureEncoder)
    kk = datasets.kkbox.FeatureEncoder.__new__(datasets.kkbox.FeatureEncoder)
    assert list(kk.bucketize_age(table, "age")) == list(jkk.bucketize_age(df, "age"))
    assert list(kk.extract_country_code(table, "isrc")) == \
        list(jkk.extract_country_code(df, "isrc"))
    stamps = ["1101", "511", "1231", "0214", "706"]
    jtm = jax_datasets.tmall.FeatureEncoder.__new__(jax_datasets.tmall.FeatureEncoder)
    tm = datasets.tmall.FeatureEncoder.__new__(datasets.tmall.FeatureEncoder)
    tdf, ttable = pd.DataFrame({"time_stamp": stamps}), {
        "time_stamp": np.array(stamps, dtype=object)}
    for hook in ("convert_weekday", "convert_weekend"):
        assert list(getattr(tm, hook)(ttable, "w")) == list(getattr(jtm, hook)(tdf, "w"))


def test_pickled_encoder_transforms_again(tmp_path):
    csv = str(tmp_path / "csv")
    jax_make_mltag_like(csv, n_train=600, n_valid=100, n_test=100, seed=1)
    params = {"dataset_id": "pickled", "feature_cols": MLTAG_COLS, "label_col": LABEL,
              "data_root": str(tmp_path / "d"), "train_data": csv + "/train.csv"}
    enc = FeatureEncoder(**params)
    build_dataset(enc, **params)
    again = FeatureEncoder(**params).load_pickle()
    assert again.version == "torch"
    table = again.transform(again.preprocess(again.read_csv(csv + "/train.csv")))
    np.testing.assert_array_equal(table, np.load(os.path.join(enc.data_dir, "train.npy")))
    with pytest.raises(IOError):
        FeatureEncoder(**dict(params, dataset_id="other")).load_pickle(enc.pickle_file)


def test_encoded_categoricals_fit_but_do_not_transform(tmp_path):
    """Numeric-bucket and hash-bucket columns fit (vocabulary sizes in
    the map) and, as in the JAX package, raise at transform."""
    table = {"score": np.array([0.5, 1.5, 2.5, 3.5, 9.0]),
             "tag": np.array(["a", "b", "a", "c", "a"], dtype=object),
             "label": np.array([1.0, 0.0, 1.0, 0.0, 1.0])}
    for spec, vocab in (({"name": "score", "dtype": "float", "encoder": "numeric_bucket",
                          "num_buckets": 4}, 4),
                        ({"name": "tag", "dtype": "str", "encoder": "hash_bucket",
                          "num_buckets": 10}, 3)):
        enc = FeatureEncoder(feature_cols=[dict(spec, active=True, type="categorical")],
                             label_col=LABEL, dataset_id="buckets",
                             data_root=str(tmp_path))
        enc.fit(dict(table))
        assert enc.feature_map.feature_specs[spec["name"]]["vocab_size"] == vocab
        with pytest.raises(NotImplementedError):
            enc.transform(dict(table))
