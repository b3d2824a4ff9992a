"""Grid-search autotuner (port of rat_tpu.autotuner).

``enumerate_params`` expands a tuner file's ``tuner_space`` into hashed
expids with generated dataset and model config files; ``grid_search``
runs one ``run_expid`` subprocess per execution slot. The sweep is two
grids, dataset-level knobs (each combination its own hashed
``dataset_id``, since it changes the built arrays) and model-level
knobs, crossed at the end into hashed expids. An expid is
``<base>_<seq>_<md5(print_to_json(point) + salt)[:8]>``, the JAX
package's for the same tuner file, letter for letter.

A slot is a card index, passed to the run as ``--gpu <slot>`` (``-1``
for the CPU) and exported as RAT_TPU_SLOT, or a dict of environment
overrides: ``{"CUDA_VISIBLE_DEVICES": "0,1", "RAT_TPU_MESH": "2x1"}``
gives a run two cards as a 2x1 mesh, ``{"RAT_TPU_PLATFORM": "cpu"}``
runs it on the CPU. The YAML files are read and written by the port's
own subset reader and writer (utils/yaml_subset.py), so no path needs
PyYAML.
"""

import hashlib
import itertools
import os
import subprocess
import sys
import time

import numpy as np

from .utils.config import _config_shards, _resolve_sections, print_to_json
from .utils.yaml_subset import dump, safe_load


def load_model_config(config_dir, experiment_id):
    """Base+expid merged view WITHOUT the dataset section (the tuner
    owns dataset merging)."""
    shards = _config_shards(config_dir, "model_config")
    sections = _resolve_sections(shards, ["Base", experiment_id])
    params = dict(sections.get("Base") or {})
    params.update(sections.get(experiment_id) or {})
    if "dataset_id" not in params:
        raise RuntimeError(
            "experiment_id={} is not valid in config.".format(experiment_id))
    params["model_id"] = experiment_id
    return params


def load_dataset_config(config_dir, dataset_id):
    shards = _config_shards(config_dir, "dataset_config")
    return dict(_resolve_sections(shards, [dataset_id]).get(dataset_id) or {})


def _grid(base_params, tuner_space):
    """Yield one dict per point of the cross-product of the tuned keys,
    holding every base key (tuned keys swept, the rest fixed)."""
    keys = list(base_params)
    axes = [tuner_space.get(k, [base_params[k]]) for k in keys]
    for point in itertools.product(*axes):
        yield dict(zip(keys, point))


def _hash_id(params, salt=""):
    digest = hashlib.md5((print_to_json(params) + salt).encode("utf-8"))
    return digest.hexdigest()[:8]


def _write_yaml(path, obj):
    with open(path, "w") as fh:
        fh.write(dump(obj))


def enumerate_params(config_file, exclude_expid=[]):
    """Expand tuner_space into per-combination config files; returns the
    generated config directory."""
    with open(config_file, "r") as fh:
        tuner = safe_load(fh)
    space = {k: v if isinstance(v, list) else [v]
             for k, v in tuner["tuner_space"].items()}
    base_expid = tuner["base_expid"]

    # base model/dataset sections: inline in the tuner file, or pulled
    # from an existing config directory
    base_dir = tuner.get("base_config", os.path.dirname(config_file))
    if "model_config" in tuner:
        model_base = dict(tuner["model_config"].get("Base", {}))
        model_base.update(tuner["model_config"][base_expid])
    else:
        model_base = load_model_config(base_dir, base_expid)
    dataset_id = tuner.get("dataset_id", model_base["dataset_id"])
    if "dataset_config" in tuner:
        dataset_base = tuner["dataset_config"][dataset_id]
    else:
        dataset_base = load_dataset_config(base_dir, dataset_id)
    if model_base["dataset_id"] == "TBD":
        model_base["dataset_id"] = dataset_id
        base_expid = model_base["model"] + "_" + dataset_id

    unknown = set(space) - set(model_base) - set(dataset_base)
    if unknown:
        raise RuntimeError("Invalid params in tuner config: {}".format(unknown))

    out_dir = config_file[:-len(".yaml")] if config_file.endswith(".yaml") \
        else config_file
    os.makedirs(out_dir, exist_ok=True)

    # dataset grid: h5-format combos keep the plain dataset_id (the
    # arrays are fixed); anything else becomes a hashed dataset id
    dataset_combos = {}
    for point in _grid(dataset_base, space):
        if point.get("data_format") == "h5":
            dataset_combos[dataset_id] = point
        else:
            dataset_combos["{}_{}".format(dataset_id, _hash_id(point))] = point
    _write_yaml(os.path.join(out_dir, "dataset_config.yaml"), dataset_combos)

    # model grid x dataset ids -> hashed, numbered expids
    expids = {}
    cross = itertools.product(_grid(model_base, space), dataset_combos)
    for seq, (model_point, ds_id) in enumerate(cross, start=1):
        point = dict(model_point, dataset_id=ds_id)
        # debug runs salt the hash from numpy's global RNG, as in the
        # JAX package, so that their expids never repeat
        salt = str(np.random.randint(1e8)) if point.get("debug") else ""
        expid = "{}_{:03d}_{}".format(base_expid, seq, _hash_id(point, salt))
        if expid not in exclude_expid:
            expids[expid] = point
    _write_yaml(os.path.join(out_dir, "model_config.yaml"), expids)
    print("Enumerate all tuner configurations done.")
    return out_dir


def load_experiment_ids(config_dir):
    expids = []
    for shard in _config_shards(config_dir, "model_config"):
        with open(shard, "r") as fh:
            expids.extend((safe_load(fh) or {}).keys())
    return sorted(expids)


def _slot_env(slot):
    """Environment of one slot's subprocess: the parent's, plus a dict
    slot's overrides, or RAT_TPU_SLOT for a plain slot."""
    env = dict(os.environ)
    if isinstance(slot, dict):
        env.update({str(k): str(v) for k, v in slot.items()})
    else:
        env["RAT_TPU_SLOT"] = str(slot)
    return env


def _slot_args(slot):
    """A plain slot is the run's card (``--gpu``; -1 is the CPU); a dict
    slot picks its device through the environment."""
    return [] if isinstance(slot, dict) else ["--gpu", str(slot)]


def grid_search(version, config_dir, slot_list, expid_tag=None,
                runner="rat_tpu_torch.cli.run_expid"):
    """Run every enumerated expid, one subprocess per free slot (slot
    width = parallelism), polling every 5 s for a free one. Returns
    {expid: exit code}."""
    experiment_id_list = load_experiment_ids(config_dir)
    if expid_tag is not None:
        experiment_id_list = [expid for expid in experiment_id_list
                              if str(expid_tag) in expid]
        assert len(experiment_id_list) > 0, \
            "tag={} does not match any expid!".format(expid_tag)
    slot_list = list(slot_list)
    idle_queue = list(range(len(slot_list)))
    processes, running = dict(), dict()
    while len(experiment_id_list) > 0:
        if len(idle_queue) > 0:
            idle_idx = idle_queue.pop(0)
            expid = experiment_id_list.pop(0)
            slot = slot_list[idle_idx]
            cmd = [sys.executable, "-u", "-m", runner, "--version", str(version),
                   "--config", config_dir, "--expid", expid] + _slot_args(slot)
            running[idle_idx] = expid
            processes[expid] = subprocess.Popen(cmd, env=_slot_env(slot))
        else:
            time.sleep(5)
            for idle_idx, expid in list(running.items()):
                if processes[expid].poll() is not None:
                    del running[idle_idx]
                    idle_queue.append(idle_idx)
    return {expid: p.wait() for expid, p in processes.items()}
