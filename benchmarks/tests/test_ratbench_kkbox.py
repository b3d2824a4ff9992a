"""The ``kkbox-train`` cell (configuration ``rat_m2-kkbox``, runner
``train_masked``) on the CPU: its faults refused (a clamp-only loss
stopped at set-up, before any data, with a non-zero exit; the three
training faults read ``correct`` false), a traced rehearsal that reads
the module path's share, the reader of that share, the configuration
against the repo's published one, and a reference that loads nothing
of JAX, the JAX package or the program. The rehearsal and the control
are test_ratbench_runs.py's, as for every cell."""

import json
import os
import subprocess
import sys
import time

import pytest

import rat_tpu_torch
from rat_tpu_torch import tracing

from benchmarks import harness
from benchmarks.harness import Run
from benchmarks.tests import faults_masked
from benchmarks.tests.helpers import ROOT, rehearse, run

CELL = "kkbox-train"
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _fault(fault, seed=9):
    return run([fault, "--workload", CELL, "--seed", str(seed), "--seconds", "1",
                "--trace", "0", "--rehearse-cpu"], module="benchmarks.tests.faults_masked",
               env={"PYTHONPATH": ROOT})


def test_clamp_only_loss_stops_the_run_at_set_up():
    t0 = time.perf_counter()
    rc, last, err = _fault("clamp_only_bce", seed=3400000003)
    assert rc != 0 and last is None
    assert "set-up check failed" in err and "gradient nan" in err
    # before the data, the retrieval and the Trainer: within the imports
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("fault", [f for f in faults_masked.FAULTS if f != "clamp_only_bce"])
def test_fault_is_not_correct(fault):
    rc, last, err = _fault(fault)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False


def test_traced_rehearsal_reads_the_module_path():
    rc, last, err = rehearse(CELL, seed=2 ** 31 + 5, extra=["--trace", "1"])
    assert rc == 0, err[-3000:]
    assert last["correct"] is True
    layer = {m["name"] for m in SPEC["per_layer"] if harness.applies(m, CELL)}
    assert layer == {"module_path_share.kkbox", "train_mfu.kkbox"}
    # the CPU's profiler records the program's counters; train_mfu reads
    # the card alone
    assert last["metrics"] == {"module_path_share.kkbox": {"value": 100.0, "unit": "%"}}


def _read_with(monkeypatch, counters):
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    return harness.reader("module_path_share.kkbox")(Run())


def test_module_path_share_reader(monkeypatch):
    # the parent's counters: no path counter
    assert _read_with(monkeypatch, {"train.eager_steps": 7}) is None
    assert _read_with(monkeypatch, {"model.path.module": 0, "model.path.fused": 0}) is None
    assert _read_with(monkeypatch, {"model.path.module": 30}) == 100.0
    assert _read_with(monkeypatch, {"model.path.module": 30, "model.path.fused": 90}) == 25.0
    monkeypatch.delattr(rat_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "rat_tpu_torch.tracing", None)
    assert harness.reader("module_path_share.kkbox")(Run()) is None


def _yaml(path):
    from rat_tpu_torch.utils.yaml_subset import safe_load
    with open(path) as fh:
        return safe_load(fh.read())


def test_configuration_is_the_published_one_but_what_it_reduces():
    entry = next(c for c in SPEC["configs"] if c["name"] == "rat_m2-kkbox")
    cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
    mirror = os.path.join(ROOT, cfg["mirrors"])
    model = _yaml(os.path.join(mirror, "model_config.yaml"))[cfg["experiment"]]
    dataset = _yaml(os.path.join(mirror, "dataset_config.yaml"))[model["dataset_id"]]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced_from"]) == ["patience", "rows"]
    changed = sorted(k for k, v in model.items() if k in cfg and cfg[k] != v)
    assert changed == ["patience"] and cfg["reduced_from"]["patience"]["published"] == 2
    for key in ("embedding_dim", "num_heads", "dim_head", "depth", "scale_dim",
                "dnn_hidden_units", "batch_size", "learning_rate", "embedding_regularizer",
                "batch_norm", "emb_dropout", "net_dropout", "dropout", "use_wide"):
        assert cfg[key] == model[key], key
    seqs = {}
    names = []
    for col in dataset["feature_cols"]:
        for name in col["name"] if isinstance(col["name"], list) else [col["name"]]:
            names.append(name)
            if col["type"] == "sequence":
                seqs[name] = {"max_len": col["max_len"], "encoder": col["encoder"]}
    assert list(cfg["dataset"]["fields"]) == names and cfg["dataset"]["sequences"] == seqs
    for key, value in dataset["retrieval_configs"].items():
        if key in cfg["dataset"]["retrieval"]:
            assert cfg["dataset"]["retrieval"][key] == value, key
    # the rows cut, the published 8:1:1 kept
    rows, published = cfg["dataset"]["rows"], cfg["reduced_from"]["rows"]["published"]
    assert published == {"train": 5901932, "valid": 737743, "test": 737743}
    assert rows["train"] == 8 * rows["valid"] == 8 * rows["test"]
    assert rows["train"] % cfg["batch_size"] == 0


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmarks.reference.rat_kkbox, benchmarks.data_seq, benchmarks.weights\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "rat_tpu_torch" not in loaded and not loaded & set(harness.BANNED)
