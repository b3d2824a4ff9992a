"""Whole runs of each cell in a child process, as a benchmark check makes them:
rehearsed on the CPU at tiny sizes (the path, the shapes, the last line,
``correct``), under each planted fault and as the control (``correct``
must come out false), without a card (the run must fail), the modules
that the benchmark and its reference load, and on the card."""

import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness
from benchmarks.tests import faults
from benchmarks.tests.helpers import ROOT, rehearse, run

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [c["name"] for c in SPEC["workloads"]]
RUNNERS = {c: harness.resolve(c)[3]["runner"] for c in CELLS}


def _cell_metrics(cell, kind):
    return {m["name"] for m in SPEC[kind] if harness.applies(m, cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    rc, last, err = rehearse(cell, seed=2 ** 31 + 77)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert set(last["metrics"]) == _cell_metrics(cell, "end_to_end")
    assert all(v["value"] > 0 for v in last["metrics"].values())
    assert last["attempted"] > 0 and last["failed"] == 0
    assert err.strip().splitlines()[-1] == "correct: True"


def test_traced_rehearsal_reads_layers():
    rc, last, err = rehearse("mltag-retrieve", extra=["--trace", "1"])
    assert rc == 0, err[-3000:]
    assert set(last["metrics"]) <= _cell_metrics("mltag-retrieve", "per_layer")
    assert "busy_s" in last["device"] and "window_s" in last["device"]
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS[RUNNERS[c]]])
def test_fault_is_not_correct(cell, fault):
    rc, last, err = run([fault, "--workload", cell, "--seed", "9", "--seconds", "1",
                         "--trace", "0", "--rehearse-cpu"], module="benchmarks.tests.faults",
                        env={"PYTHONPATH": ROOT})
    assert rc == 0, err[-3000:]
    assert last["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    rc, last, err = rehearse(cell, seed=21, extra=["--control"])
    assert rc == 0, err[-3000:]
    assert set(last["checks"]) == set(harness.resolve(cell)[4])
    assert all(c["value"] == c["value"] for c in last["checks"].values())
    assert last["correct"] is False
    assert err.strip().splitlines()[-1] == "control: correct: False"


def test_no_card_no_result():
    rc, last, err = run(["--workload", "mltag-retrieve", "--seed", "1", "--seconds", "1",
                         "--trace", "0"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert rc != 0 and last is None


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_no_module_loads_jax_or_the_jax_package():
    code = ("import glob, importlib, importlib.util, json, os, sys\n"
            "from benchmarks import harness\n"
            "for path in sorted(glob.glob('benchmarks/**/*.py', recursive=True)):\n"
            "    if '/metrics/' in path:\n"
            "        harness.reader(os.path.basename(path)[:-3])\n"
            "    elif not path.endswith('run.py'):\n"
            "        importlib.import_module(path[:-3].replace('/', '.'))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not _loaded(code) & set(harness.BANNED)


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmarks.reference, benchmarks.reference.bm25, "
            "benchmarks.reference.rat, benchmarks.reference.judge, benchmarks.weights\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = _loaded(code)
    assert "rat_tpu_torch" not in loaded and not loaded & set(harness.BANNED)


@pytest.mark.card
def test_cells_on_the_card(card):
    for cell in CELLS:
        rc, last, err = run(["--workload", cell, "--seed", "2147483999", "--seconds", "2",
                             "--trace", "0"])
        assert rc == 0, err[-3000:]
        assert last["correct"] is True and last["device"]["platform"] == "gpu"
