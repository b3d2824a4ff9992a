"""The port's autotuner (rat_tpu_torch/autotuner.py) against the JAX
package's (rat_tpu/autotuner.py), and the port's YAML writer
(rat_tpu_torch/utils/yaml_subset.py::dump), on the CPU.

The three tuner files of tests/test_autotuner.py expand, in each
package, into the same expids (letter for letter: md5 of the same
``print_to_json`` text), the same dataset ids and generated config
dicts, read back with PyYAML and with the port's reader; unknown keys
raise; ``grid_search`` hands a plain slot to its run as ``--gpu <slot>``
(with RAT_TPU_SLOT) and a dict slot as environment overrides. The
writer's text reads back equal under PyYAML's ``safe_load`` and the
port's reader. Then chip_smoke's autotune phase runs a two-expid sweep
on the CPU at a tiny size."""

import math
import os

import pytest
import yaml

import chip_smoke
from rat_tpu import autotuner as jax_tuner
from rat_tpu_torch import autotuner
from rat_tpu_torch.utils.yaml_subset import dump, safe_load

TUNERS = {
    "grid": {
        "base_expid": "RAT_m2_base",
        "model_config": {
            "Base": {"model_root": "./exps/", "debug": False},
            "RAT_m2_base": {"model": "RAT_m2", "dataset_id": "ds1",
                            "learning_rate": 1e-3, "embedding_dim": 10}},
        "dataset_config": {"ds1": {"data_format": "csv", "data_root": "./data/",
                                   "min_categr_count": 1}},
        "tuner_space": {"learning_rate": [1e-3, 1e-4], "embedding_dim": [8, 16, 32]},
    },
    "dataset_params": {
        "base_expid": "e1",
        "model_config": {"e1": {"model": "RAT_m2", "dataset_id": "ds1", "debug": False}},
        "dataset_config": {"ds1": {"data_format": "csv", "min_categr_count": 1}},
        "tuner_space": {"min_categr_count": [1, 5]},
    },
    "slots": {
        "base_expid": "RAT_m2_base",
        "model_config": {
            "Base": {"model_root": "./exps/"},
            "RAT_m2_base": {"model": "RAT_m2", "dataset_id": "ds1",
                            "learning_rate": 1e-3}},
        "dataset_config": {"ds1": {"data_format": "csv"}},
        "tuner_space": {"learning_rate": [1e-3, 1e-4, 1e-5]},
    },
}


def _enumerate(module, root, tuner):
    os.makedirs(root)
    path = os.path.join(root, "tuner.yaml")
    with open(path, "w") as fh:
        fh.write(yaml.dump(tuner))
    return module.enumerate_params(path)


def _read(path, reader):
    with open(path) as fh:
        return reader(fh)


@pytest.mark.parametrize("name", sorted(TUNERS))
def test_expids_and_generated_configs_equal_jax(tmp_path, name):
    jax_dir = _enumerate(jax_tuner, str(tmp_path / "jax"), TUNERS[name])
    port_dir = _enumerate(autotuner, str(tmp_path / "torch"), TUNERS[name])
    ids = autotuner.load_experiment_ids(port_dir)
    assert ids == jax_tuner.load_experiment_ids(jax_dir)
    assert len(ids) == {"grid": 6, "dataset_params": 2, "slots": 3}[name]
    for stem in ("model_config", "dataset_config"):
        want = _read(os.path.join(jax_dir, stem + ".yaml"), yaml.safe_load)
        path = os.path.join(port_dir, stem + ".yaml")
        assert _read(path, yaml.safe_load) == want
        assert _read(path, safe_load) == want
    assert autotuner.load_model_config(port_dir, ids[0]) == \
        jax_tuner.load_model_config(jax_dir, ids[0])


def test_unknown_keys_raise(tmp_path):
    tuner = dict(TUNERS["dataset_params"], tuner_space={"not_a_real_param": [1, 2]})
    with pytest.raises(RuntimeError, match="not_a_real_param"):
        _enumerate(autotuner, str(tmp_path / "t"), tuner)


def test_grid_search_passes_plain_slots_as_gpu_and_dict_slots_as_environment(
        tmp_path, monkeypatch):
    out_dir = _enumerate(autotuner, str(tmp_path / "t"), TUNERS["slots"])
    marks = tmp_path / "marks"
    marks.mkdir()
    (tmp_path / "dummy_runner.py").write_text(
        "import argparse, os\n"
        "p = argparse.ArgumentParser()\n"
        "for a in ('--version', '--config', '--expid', '--gpu'):\n"
        "    p.add_argument(a)\n"
        "args = p.parse_args()\n"
        "open(os.path.join(os.environ['MARK_DIR'], args.expid), 'w').write(\n"
        "    '{} {} {} {}'.format(args.version, args.gpu, os.environ.get('RAT_TPU_SLOT'),\n"
        "                         os.environ.get('RAT_TPU_PLATFORM')))\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("MARK_DIR", str(marks))
    rcs = autotuner.grid_search("torch", out_dir, [3, {"RAT_TPU_PLATFORM": "cpu"}],
                                runner="dummy_runner")
    ids = autotuner.load_experiment_ids(out_dir)
    assert rcs == {expid: 0 for expid in ids}
    got = {f.name: f.read_text() for f in marks.iterdir()}
    # the first two expids start at once, one per slot; the third waits
    # for a free one
    assert got[ids[0]] == "torch 3 3 None"
    assert got[ids[1]] == "torch None None cpu"
    assert got[ids[2]] in ("torch 3 3 None", "torch None None cpu")


def test_debug_salts_the_hash_from_numpy(tmp_path):
    """debug: true salts each expid with numpy's global RNG, as in the
    JAX package: the same seed, the same expids."""
    import numpy as np
    tuner = dict(TUNERS["slots"])
    tuner["model_config"] = {"Base": {"debug": True},
                             "RAT_m2_base": TUNERS["slots"]["model_config"]["RAT_m2_base"]}
    np.random.seed(5)
    jax_ids = jax_tuner.load_experiment_ids(_enumerate(jax_tuner, str(tmp_path / "j"), tuner))
    np.random.seed(5)
    ids = autotuner.load_experiment_ids(_enumerate(autotuner, str(tmp_path / "p"), tuner))
    assert ids == jax_ids


DOCS = [
    {"lr": 1e-05, "b": 0.0001, "c": [1e-3, 1e-4, 0.5], "big": 1e16, "tiny": -1e-300,
     "ints": [0, -3, 12], "flags": [True, False], "none": None, "inf": float("inf"),
     "nested": {"x": {"y": [1, [2, 3]], "z": {}}, "empty": []},
     "cols": [{"name": ["a", "b"], "dtype": "str", "active": True}, {"m": None},
              [{"deep": 1}], "plain"],
     "strings": ["1e-3", "1.5", "12", "0x10", "yes", "No", "null", "~", "", " pad",
                 "a: b", "#x", "a #b", "|", "-", "- a", "it's", 'say "hi"', "12:30",
                 "2020-01-01", "<<", "=", "tab\there", "line\nbreak", "é ü", "\x85",
                 "./data/", "RAT_m2_demo", "10-fold", "True"],
     5: "int key", 1.5: "float key", "true": "a bool-looking key"},
    [1, 2.5, "x"],
    "top",
]


@pytest.mark.parametrize("doc", DOCS, ids=["mapping", "list", "scalar"])
def test_yaml_dump_reads_back_under_pyyaml_and_the_port_reader(doc):
    text = dump(doc)
    assert yaml.safe_load(text) == doc
    assert safe_load(text) == doc


def test_yaml_dump_writes_floats_as_pyyaml_does():
    assert dump({"a": 1e-05, "b": 0.0001, "c": 1.0, "d": float("-inf")}) == \
        "a: 1.0e-05\nb: 0.0001\nc: 1.0\nd: -.inf\n"
    assert math.isnan(safe_load(dump({"n": float("nan")}))["n"])


def test_chip_smoke_autotune_phase_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # both runs on the CPU at once
    res, launches = chip_smoke.autotune("cpu", 0, str(tmp_path), rows=(1200, 300, 300),
                                        epochs=1)
    assert len(res["expids"]) == 2 and set(res["exit_codes"].values()) == {0}
    assert set(res["results"]) == set(res["expids"])
    assert all("AUC" in r["val"] for r in res["results"].values())
    assert launches == {"cross_intra_block": 0, "bm25_topk": 0, "bm25_score_chunk": 0}
    # K2 at fold 0 (120 queries x 1,080 rows) and the valid and test splits
    checks = res["kernel_checks"]
    assert checks["k2_calls_by_queries"] == {120: 1, 300: 2}
    assert checks["k2_pool_rows"] == [1080, 1200] and len(checks["k1_max_abs_err"]) == 3
