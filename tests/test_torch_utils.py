"""The port's host utilities against the JAX package's: the merged YAML
experiment configs of every shipped config directory, the FeatureMap
JSON round trip, the Monitor, and seeding."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from rat_tpu.features import FeatureMap as JFeatureMap
from rat_tpu.utils import Monitor as JMonitor
from rat_tpu.utils import load_config as jload_config
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.utils import (Monitor, load_config, print_to_json,
                                 seed_everything)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIRS = sorted(os.path.dirname(p) for p in glob.glob(
    os.path.join(REPO, "configs", "*", "*", "model_config.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "demo", "model_config.yaml")))


@pytest.mark.parametrize("config_dir", CONFIG_DIRS,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_load_config_matches_jax(config_dir):
    with open(os.path.join(config_dir, "model_config.yaml")) as fh:
        expids = [k for k in yaml.safe_load(fh) if k != "Base"]
    assert expids
    for expid in expids:
        assert load_config(config_dir, expid) == jload_config(config_dir, expid)
    with pytest.raises(ValueError):
        load_config(config_dir, "no_such_expid")


def test_feature_map_round_trip(tmp_path, tiny_feature_map):
    path = str(tmp_path / "feature_map.json")
    tiny_feature_map.save(path)
    fm = FeatureMap("tiny", str(tmp_path))
    fm.load(path)
    assert fm.to_dict() == tiny_feature_map.to_dict()
    back = JFeatureMap("tiny", str(tmp_path))
    fm.save(path)
    back.load(path)
    assert back.to_dict() == tiny_feature_map.to_dict()
    with pytest.raises(RuntimeError):
        FeatureMap("other", str(tmp_path)).load(path)


def test_monitor_and_print_helpers():
    logs = {"AUC": 0.8, "logloss": 0.4}
    for kv in ("AUC", {"AUC": 1, "logloss": -1}):
        assert Monitor(kv).get_value(logs) == JMonitor(kv).get_value(logs)
    assert '"AUC": "0.8"' in print_to_json(logs)


def test_seed_everything_seeds_numpy_and_torch():
    seed_everything(11)
    a = (np.random.rand(3), torch.rand(3))
    seed_everything(11)
    b = (np.random.rand(3), torch.rand(3))
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])
