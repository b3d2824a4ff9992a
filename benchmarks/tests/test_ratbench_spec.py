"""BENCHMARK.json against the benchmark contract, every cell resolved to
its files by name, and each configuration file against the repo's
configuration it mirrors."""

import json
import os
import re

import pytest

from benchmarks import harness
from benchmarks.tests.helpers import ROOT

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [c["name"] for c in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|heads|width|size$|scale_dim")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmarks/run.py"]
    assert SPEC["paths"] == ["benchmarks"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    # a full check of 24 cells fits its time
    cells = 24
    assert 2 + 14 * cells * (SPEC["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert harness.applies(e2e[m["moves"]], cell)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_cells_and_configs():
    assert len(set(CELLS)) == len(CELLS)
    assert len({(c["config"], c["traffic"]) for c in SPEC["workloads"]}) == len(CELLS)
    configs = {c["name"]: c for c in SPEC["configs"]}
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["config"] in configs and cell["chips"] in (1, 4) and _line(cell["why"])
        e2e = [m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, cell["name"]) for m in SPEC["per_layer"])
    assert sum(c["chips"] == 4 for c in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    used = {c["config"] for c in SPEC["workloads"]}
    for cfg in SPEC["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["name"] in used and _line(cfg["source"]) and _line(cfg["why"])
        assert cfg["file"].startswith("benchmarks/") and len(cfg["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in cfg["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec, entry, cfg, traffic, limits = harness.resolve(cell)
    drive = harness.runner(traffic)
    for fn in ("setup", "window", "check"):
        assert callable(getattr(drive, fn))
    for m in spec["per_layer"]:
        if harness.applies(m, cell):
            assert callable(harness.reader(m["name"]))
    assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())
    assert cfg["name"] == entry["config"]


def _yaml(path):
    from rat_tpu_torch.utils.yaml_subset import safe_load
    with open(path) as fh:
        return safe_load(fh.read())


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_mirrors_the_repo(entry):
    cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
    mirror = os.path.join(ROOT, cfg["mirrors"])
    model = _yaml(os.path.join(mirror, "model_config.yaml"))[cfg["experiment"]]
    dataset = _yaml(os.path.join(mirror, "dataset_config.yaml"))[model["dataset_id"]]
    changed = sorted(k for k, v in model.items() if k in cfg and cfg[k] != v)
    assert changed == sorted(entry["reduced"]) == sorted(cfg["reduced_from"])
    for key in changed:
        assert model[key] == cfg["reduced_from"][key]["published"]
    for key in ("embedding_dim", "num_heads", "dim_head", "depth", "scale_dim",
                "dnn_hidden_units", "batch_size", "learning_rate",
                "embedding_regularizer", "batch_norm", "emb_dropout", "use_wide"):
        assert cfg[key] == model[key], key
    names = [n for col in dataset["feature_cols"]
             for n in (col["name"] if isinstance(col["name"], list) else [col["name"]])]
    assert list(cfg["dataset"]["fields"]) == names
    for key, value in dataset["retrieval_configs"].items():
        if key in cfg["dataset"]["retrieval"]:
            assert cfg["dataset"]["retrieval"][key] == value, key
