"""A later cell is added by adding files and entries only: in a copy of
the benchmark, a new configuration file, traffic file, limits file and
per-layer metric reader, and entries for them in BENCHMARK.json, are
found by name and run, and no file the benchmark had is edited."""

import hashlib
import json
import os
import shutil

from benchmarks.tests.helpers import ROOT, rehearse, run


def _digests(root):
    out = {}
    for base, dirs, files in os.walk(os.path.join(root, "benchmarks")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _copy(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmarks"), os.path.join(root, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root, _digests(root)


def _edit_spec(root, edit):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    edit(spec)
    with open(path, "w") as fh:
        json.dump(spec, fh)


def _e2e(spec, name):
    return next(m for m in spec["end_to_end"] if m["name"] == name)


def test_a_new_cell_needs_only_new_files(tmp_path):
    root, before = _copy(tmp_path)
    bench = os.path.join(root, "benchmarks")

    with open(os.path.join(bench, "configs", "rat_m2-mltag.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="rat_m2-mltag-k3")
    cfg["dataset"]["retrieval"]["topK"] = 3
    with open(os.path.join(bench, "configs", "rat_m2-mltag-k3.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "retrieve-small.json"), "w") as fh:
        json.dump({"runner": "retrieve", "warm_passes": 1, "check_rows": 256,
                   "trace": {"start_pass": 1}}, fh)
    with open(os.path.join(bench, "limits", "k3-retrieve.json"), "w") as fh:
        json.dump({"nbr_score_gap": 1e-3}, fh)
    with open(os.path.join(bench, "metrics", "passes_run.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.counters['passes'])\n")

    def edit(spec):
        spec["configs"].append({"name": "rat_m2-mltag-k3", "source": "https://example.org/k3",
                                "file": "benchmarks/configs/rat_m2-mltag-k3.json",
                                "reduced": ["topK"], "why": "three neighbours"})
        spec["workloads"].append({"name": "k3-retrieve", "config": "rat_m2-mltag-k3",
                                  "traffic": "retrieve-small", "chips": 1, "why": "a test"})
        _e2e(spec, "retrieval_queries_per_s")["workloads"].append("k3-retrieve")
        spec["per_layer"].append({"name": "passes_run", "unit": "passes", "better": "higher",
                                  "source": "program_counter", "layer": "a test",
                                  "moves": "retrieval_queries_per_s",
                                  "workloads": ["k3-retrieve"]})

    _edit_spec(root, edit)

    env = {"PYTHONPATH": ROOT}
    rc, last, err = rehearse("k3-retrieve", cwd=root, env=env)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True and "retrieval_queries_per_s" in last["metrics"]
    rc, last, err = rehearse("k3-retrieve", cwd=root, env=env, extra=["--trace", "1"])
    assert rc == 0, err[-3000:]
    assert last["metrics"]["passes_run"]["value"] >= 1
    after = _digests(root)
    assert {k: after[k] for k in before} == before
