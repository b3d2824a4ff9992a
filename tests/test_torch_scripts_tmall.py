"""The Tmall rehearsal scripts (rat_tpu_torch.scripts.tmall_rehearsal and
tmall_rehearsal_tail) on the CPU, through chip_smoke's ``scripts`` phase
at a tiny size: ``tmall_rehearsal.main(["--scale", "2e-5", "--config",
<a copy of configs/RAT_m2/tmall_x1_002>], device="cpu")`` in a temporary
working directory (400 train, 423 test and 400 pool rows), then
``tmall_rehearsal_tail --valid-rows 100`` on that build under
``stall_guard`` in a subprocess, then the other scripts at tiny sizes.

The config copy differs from the published one only in ``batch_size``
(64 for 4096): one padded CPU step at the Tmall widths and batch 4096
takes ~80 s and ~12 GB. On the same CSVs the JAX package's own
``build_dataset`` and ``DataGenerator`` retrievals run (not its
training): ``feature_map.json`` must be byte for byte the JAX build's,
every split array-equal to its ``.h5`` dataset, and the train and valid
neighbour indices and counts equal to JAX's. The printed JSON lines
carry the JAX scripts' keys.
"""

import contextlib
import io
import json
import os

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from rat_tpu.data import build_dataset as jax_build_dataset
from rat_tpu.data.loader import DataGenerator as JaxDataGenerator
from rat_tpu.features import FeatureEncoder as JaxFeatureEncoder
from rat_tpu.utils import load_config as jax_load_config

SCALE = 2e-5
TAG = "_s2e-05"
DATASET = chip_smoke.TMALL_DATASET + TAG

# scripts/tmall_rehearsal.py's and scripts/tmall_rehearsal_tail.py's keys
REHEARSAL_KEYS = {"generate_csv", "build_csv_to_h5", "train_retrieval_20M_queries",
                  "valid_retrieval_21M_queries", "train_epoch_incl_epoch_end_eval",
                  "eval_21M_rows", "total", "scale", "valid_metrics"}
TAIL_KEYS = {"train_retrieval_cache_load", "valid_slice_retrieval_100_queries",
             "train_epoch_20M_incl_epoch_end_eval", "eval_100_rows", "total",
             "valid_metrics"}

# the phase's other scripts at tiny sizes (the Tmall profile is left out:
# the bench's Tmall tables hold 1.7M rows, seconds an Adam step here)
RUNS = (("profile_train_step", ["mltag", "2"]),
        ("degraded_ab", ["32", "2", "4"]),
        ("dedup_ab", ["--time"]),
        ("tax_probe", []),
        ("gm_encoder_ab", ["--parity", "--b", "8", "--depth", "2", "--trials", "2"]),
        ("gm_encoder_ab", ["--parity", "--b", "8", "--depth", "1", "--trials", "1",
                           "--s", "14", "--d", "40", "--heads", "8", "--dim-head", "10",
                           "--scale-dim", "2"]),
        ("chip_health", []))
SIZES = {"profile_train_step": {"batch_size": 32, "n_rows": 1000},
         "degraded_ab": {"n_rows": 1000},
         "dedup_ab": {"steps": 4, "group": 2, "batch_size": 32, "n_rows": 1000},
         "tax_probe": {"b": 16, "reps": (1, 3)}}


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    """(work dir, the phase's results, what it printed)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("scripts"))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = chip_smoke.scripts("cpu", work, scale=SCALE, tail_rows=100, runs=RUNS,
                                     sizes=SIZES, batch_size=64)
    finally:
        torch.set_num_threads(threads)
    return work, res, out.getvalue()


@pytest.fixture(scope="module")
def jax_build(phase):
    """The JAX package's build of the phase's CSVs: (its data dir, its
    feature map, the retrieval configs)."""
    work = phase[0]
    params = jax_load_config(os.path.join(work, "config"), chip_smoke.TMALL_EXPID)
    csv_dir = os.path.join(work, "data", "tmall" + TAG)
    params["dataset_id"] = DATASET
    params["data_root"] = os.path.join(work, "jax_data")
    for key in ("train_data", "valid_data", "test_data"):
        params[key] = os.path.join(csv_dir, os.path.basename(params[key]))
    params["retrieval_configs"]["retrieval_pool_data"] = os.path.join(
        csv_dir, "retrieval_pool.csv")
    enc = JaxFeatureEncoder(**params)
    jax_build_dataset(enc, train_data=params["train_data"],
                      valid_data=params["valid_data"], test_data=None,
                      retrieval_configs=params["retrieval_configs"],
                      **{k: v for k, v in params.items()
                         if k not in ("train_data", "valid_data", "test_data",
                                      "retrieval_configs")})
    fm = enc.feature_map
    rc = dict(params["retrieval_configs"])
    rc["used_col_indices"] = [fm.feature_specs[c]["index"] for c in rc["used_cols"]]
    rc["exact_match_col_indices"] = None
    return enc.data_dir, fm, rc


def _port_dir(work):
    return os.path.join(work, "data", DATASET)


def test_rehearsal_prints_the_jax_keys(phase):
    _, res, printed = phase
    lines = [l for l in printed.splitlines() if l.startswith("TMALL_REHEARSAL ")]
    assert len(lines) == 1
    line = json.loads(lines[0].split(" ", 1)[1])
    assert set(line) == REHEARSAL_KEYS
    assert line == res["rehearsal"] and line["scale"] == SCALE
    assert set(line["valid_metrics"]) == {"AUC", "logloss"}


def test_rehearsal_build_matches_jax(phase, jax_build):
    jax_dir = jax_build[0]
    port_dir = _port_dir(phase[0])
    with open(os.path.join(jax_dir, "feature_map.json"), "rb") as a, \
            open(os.path.join(port_dir, "feature_map.json"), "rb") as b:
        assert a.read() == b.read()
    rows = {"train": 400, "retrieval_pool": 400, "valid": 423}
    for split, n in rows.items():
        with h5py.File(os.path.join(jax_dir, split + ".h5"), "r") as hf:
            want = hf["data"][()]
        got = np.load(os.path.join(port_dir, split + ".npy"))
        assert got.shape[0] == n
        np.testing.assert_array_equal(got, want, err_msg=split)
    assert not os.path.exists(os.path.join(port_dir, "test.npy"))


@pytest.mark.parametrize("split", ["train", "valid"])
def test_rehearsal_neighbours_match_jax(phase, jax_build, split):
    jax_dir, fm, rc = jax_build
    gen = JaxDataGenerator(data_path=os.path.join(jax_dir, split + ".h5"),
                           batch_size=64, shuffle=False, feature_map=fm,
                           retrieval_configs=rc,
                           retrieval_pool_fname=os.path.join(jax_dir, "retrieval_pool.h5"),
                           retrieval_augmented=True)
    cached = np.load(os.path.join(_port_dir(phase[0]), "retrieval_5_{}.npz".format(split)))
    np.testing.assert_array_equal(cached["indices"], np.asarray(gen.retr_indices))
    np.testing.assert_array_equal(cached["lens"], np.asarray(gen.retr_lens))
    assert phase[1]["neighbours_checked"][split] == len(cached["indices"])


def test_tail_runs_on_the_build(phase):
    work, res, printed = phase
    lines = [l for l in printed.splitlines() if l.startswith("TMALL_REHEARSAL_TAIL ")]
    assert len(lines) == 1
    line = json.loads(lines[0].split(" ", 1)[1])
    assert set(line) == TAIL_KEYS and line == res["tail"]
    port_dir = _port_dir(work)
    np.testing.assert_array_equal(np.load(os.path.join(port_dir, "valid_slice.npy")),
                                  np.load(os.path.join(port_dir, "valid.npy"))[:100])
    assert os.path.exists(os.path.join(port_dir, "retrieval_5_valid_slice.npz"))


def test_phase_runs_every_tool_without_a_kernel(phase):
    _, res, printed = phase
    assert res["launches"] == {"cross_intra_block": 0, "bm25_topk": 0,
                               "bm25_score_chunk": 0}
    assert res["k2_tmall"] == {}
    assert list(res["seconds"]) == [" ".join([n] + a) for n, a in RUNS]
    assert "scripts profile_train_step mltag 2: mltag group=2: 4 steps profiled" in printed
