"""The port's CLI (rat_tpu_torch/cli/run_expid.py) with ``data_block_size``
set, from CSV to results line, on the CPU, and chip_smoke's blocks
phase at a tiny size.

Blocking changes what a run computes: each train block retrieves from
its own folds (or, with ``inter_block_retrieval``, from the other
blocks), the valid and test splits retrieve from the first train block,
and the batches are drawn block by block. So a blocked run's results
line equals the unblocked run's only where the blocks are the whole
split: with a block size above every split's rows, the build writes
``<split>_part_0.npy`` and the results line must equal the unblocked
run's exactly (one thread, so that the CPU's sums repeat). With three
train blocks the check is on what each stage wrote: each block's cache
equals the X-fold retrieval of that block alone, each valid block's the
retrieval against the first train block, and ``Stage seconds`` has a
retrieval time per block."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
import rat_tpu_torch.cli.run_expid as cli
from rat_tpu_torch.data.loader import _fold_self_retrieval, _pool_retrieval
from rat_tpu_torch.data.synthetic import make_mltag_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPID = "RAT_m2_demo_10fold_retrieval"
RETRIEVAL = {"used_col_indices": [0, 1, 2], "exact_match_col_indices": None,
             "split_type": "10-fold", "label_wise": False, "qry_batch_size": 5000,
             "db_chunk_size": 50000, "topK": 5}


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("csv"))
    make_mltag_like(out, n_train=2500, n_valid=700, n_test=400, n_users=60, n_items=40,
                    n_tags=20, seed=2)
    return out


def _run(root, csv_dir, block_rows=None):
    """The demo experiment at two epochs from ``csv_dir``'s CSVs in its
    own working directory; returns (results line, data dir, stage
    seconds from the log)."""
    os.makedirs(root)
    config = os.path.join(root, "configs")
    shutil.copytree(os.path.join(REPO, "configs", "demo"), config)
    path = os.path.join(config, "model_config.yaml")
    with open(path) as fh:
        text = fh.read()
    extra = "" if block_rows is None else "    data_block_size: {}\n".format(block_rows)
    with open(path, "w") as fh:
        fh.write(text.replace("    epochs: 20\n", "    epochs: 2\n" + extra))
    path = os.path.join(config, "dataset_config.yaml")
    with open(path) as fh:
        text = fh.read().replace("./data/demo/", csv_dir + "/")
    with open(path, "w") as fh:
        fh.write(text)
    cwd, threads = os.getcwd(), torch.get_num_threads()
    try:
        os.chdir(root)
        torch.set_num_threads(1)
        cli.run_experiment("./configs", EXPID, gpu=-1)
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    with open(os.path.join(root, "exps", "demo", "demo_10fold_retrieval",
                           EXPID + ".csv")) as fh:
        line = fh.read().splitlines()[-1]
    with open(os.path.join(root, "exps", "demo", "demo_10fold_retrieval",
                           EXPID + ".log")) as fh:
        stages = [ln for ln in fh.read().splitlines() if "Stage seconds: " in ln]
    return line, os.path.join(root, "data", "demo_10fold_retrieval"), stages


def _metrics(line):
    return re.search(r",\[val\] (.*)$", line.strip()).group(1)


def test_one_block_equals_the_unblocked_run(tmp_path, csv_dir):
    line, data_dir, _ = _run(str(tmp_path / "plain"), csv_dir)
    line_b, data_dir_b, _ = _run(str(tmp_path / "blocked"), csv_dir, block_rows=100_000)
    assert sorted(f for f in os.listdir(data_dir_b) if f.endswith(".npy")) == [
        "test_part_0.npy", "train_part_0.npy", "valid_part_0.npy"]
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(
            np.load(os.path.join(data_dir, split + ".npy")),
            np.load(os.path.join(data_dir_b, split + "_part_0.npy")))
    assert _metrics(line_b) == _metrics(line)


def test_three_train_blocks_cache_each_block(tmp_path, csv_dir):
    line, data_dir, stages = _run(str(tmp_path / "blocked"), csv_dir, block_rows=1000)
    assert "[test] AUC: " in line and float(re.search(r"AUC: ([0-9.]+)", line).group(1)) > 0.5
    (stages,) = [json.loads(s.split("Stage seconds: ", 1)[1]) for s in stages]
    assert set(stages["train_retrieval"]) == {"train_part_{}.npy".format(i) for i in range(3)}
    assert isinstance(stages["valid_retrieval"], float)   # one valid block
    train = [np.load(os.path.join(data_dir, "train_part_{}.npy".format(i)))
             for i in range(3)]
    assert [len(b) for b in train] == [1000, 1000, 500]
    for i, block in enumerate(train):
        with np.load(os.path.join(data_dir, "retrieval_5_train_part_{}.npz".format(i))) as c:
            got = (c["indices"], c["values"], c["lens"])
        for a, b in zip(got, _fold_self_retrieval(block, dict(RETRIEVAL), device="cpu")):
            np.testing.assert_array_equal(a, b)
    valid = np.load(os.path.join(data_dir, "valid_part_0.npy"))
    with np.load(os.path.join(data_dir, "retrieval_5_valid_part_0.npz")) as c:
        got = (c["indices"], c["values"], c["lens"])
    for a, b in zip(got, _pool_retrieval(valid, train[0], dict(RETRIEVAL), device="cpu")):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_blocks_phase_on_cpu(tmp_path):
    """Both commands of the phase at a tiny size: three train blocks, two
    valid blocks, one test block, batches of 256 (five steps: the
    profile starts at step 2 and ends with the epoch); on the CPU no
    kernel is launched."""
    res, launches = chip_smoke.blocks(
        "cpu", 0, str(tmp_path), rows=(1200, 700, 300),
        ids={"n_users": 30, "n_items": 20, "n_tags": 15}, block_rows=500, batch_size=256,
        timeout=300)
    assert res["blocks"] == {"train": [500, 500, 200], "valid": [500, 200], "test": [300]}
    zero = {"cross_intra_block": 0, "bm25_topk": 0, "bm25_score_chunk": 0}
    assert launches == {"a": zero, "b": zero}
    for name in ("a", "b"):
        stages = res[name]["stage_s"]
        assert set(stages["train_retrieval"]) == {"train_part_{}.npy".format(i)
                                                  for i in range(3)}
        assert set(stages["valid_retrieval"]) == {"valid_part_0.npy", "valid_part_1.npy"}
        assert res[name]["peak_split_bytes"] == res[name]["one_block_bytes"]
    assert res["b"]["one_block_bytes"] > res["a"]["one_block_bytes"]
    assert res["neighbours_checked"] == 500 and res["trace_bytes"] > 0   # all of block 1
