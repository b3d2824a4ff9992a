"""Two-tier YAML experiment config system (port of rat_tpu.utils.config).

Experiments live in ``model_config.yaml`` (or a ``model_config/``
directory of YAML shards) holding a ``Base`` section plus per-expid
sections; dataset definitions live in ``dataset_config.yaml`` (or
``dataset_config/``) keyed by ``dataset_id``. The merged view layers,
lowest precedence first: Base < expid section < dataset section.

``yaml`` is imported only inside the loader, so importing this module
(and the scoring path above it) needs no PyYAML.
"""

import glob
import json
import logging
import os


def _config_shards(config_dir, stem):
    """YAML shard paths for one config family: the single-file layout
    ``<stem>.yaml`` wins; otherwise every file under ``<stem>/``."""
    single = os.path.join(config_dir, stem + ".yaml")
    if os.path.isfile(single):
        return [single]
    return sorted(glob.glob(os.path.join(config_dir, stem, "*.yaml")))


def _resolve_sections(shards, section_names):
    """Scan shards for the named top-level sections: a later shard that
    defines a section overwrites the earlier holder, and the scan stops
    after the first shard at whose end every section has been seen."""
    import yaml
    found = {}
    for path in shards:
        with open(path, "r") as fh:
            doc = yaml.safe_load(fh) or {}
        for name in section_names:
            if name in doc:
                found[name] = doc[name]
        if len(found) == len(section_names):
            break
    return found


def load_dataset_config(config_dir, dataset_id):
    shards = _config_shards(config_dir, "dataset_config")
    sections = _resolve_sections(shards, [dataset_id])
    if dataset_id not in sections:
        raise RuntimeError(
            "dataset_id={} is not found in config.".format(dataset_id))
    return sections[dataset_id]


def load_config(config_dir, experiment_id):
    """Merged experiment view: Base < expid < dataset, plus model_id."""
    shards = _config_shards(config_dir, "model_config")
    if not shards:
        raise RuntimeError("config_dir={} is not valid!".format(config_dir))
    sections = _resolve_sections(shards, ["Base", experiment_id])
    if experiment_id not in sections:
        raise ValueError("expid={} not found in config".format(experiment_id))
    params = dict(sections.get("Base") or {})
    params.update(sections[experiment_id] or {})
    params["model_id"] = experiment_id
    params.update(load_dataset_config(config_dir, params["dataset_id"]))
    return params


_LOG_FORMAT = "%(asctime)s P%(process)d %(levelname)s %(message)s"


def set_logger(params, log_file=None):
    """Route the root logger to <model_root>/<dataset_id>/<model_id>.log
    plus the console."""
    if log_file is None:
        log_file = os.path.join(params["model_root"], params["dataset_id"],
                                params["model_id"] + ".log")
    os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
    root = logging.getLogger()
    for handler in list(root.handlers):
        root.removeHandler(handler)
    formatter = logging.Formatter(_LOG_FORMAT)
    for handler in (logging.FileHandler(log_file, mode="w"),
                    logging.StreamHandler()):
        handler.setFormatter(formatter)
        root.addHandler(handler)
    root.setLevel(logging.INFO)


def print_to_json(data, sort_keys=True):
    """Hyperparameter dump: every value stringified, optionally sorted."""
    as_str = {k: str(v) for k, v in data.items()}
    return json.dumps(as_str, indent=4, sort_keys=sort_keys)


def print_to_list(data):
    return " - ".join("{}: {:.6f}".format(k, v) for k, v in data.items())


class Monitor(object):
    """Weighted metric combination driving early stopping: a bare
    metric name means weight 1. Missing metrics contribute 0."""

    def __init__(self, kv):
        self.kv_pairs = {kv: 1} if isinstance(kv, str) else dict(kv)

    def get_value(self, logs):
        return sum(weight * logs.get(metric, 0)
                   for metric, weight in self.kv_pairs.items())
