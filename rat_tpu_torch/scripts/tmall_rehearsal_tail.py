"""Tmall rehearsal tail: the training epoch and the evaluation against
a SLICE of the valid split.

For a run that cannot afford the whole valid split's retrieval: slices
the first ``--valid-rows`` rows of the built valid split into
``valid_slice.npy`` (the port's container, beside the build), retrieves
their neighbours against the whole pool (the same kernel K2 and batch
shape as the train split's stage, so the full split's stage cost is an
extrapolation from a measured rate), then runs the training epoch on
the whole train split and evaluates the slice. It reads the build of
``tmall_rehearsal`` (``feature_map.json``, the ``.npy`` splits and the
train split's retrieval cache) under the config's ``dataset_id``, so
point ``--config`` at a config whose ``dataset_id`` names that build.

    python -m rat_tpu_torch.scripts.tmall_rehearsal_tail --valid-rows 100000

The last line is ``TMALL_REHEARSAL_TAIL {json}``: seconds per stage
(the JAX script's stage names), ``total`` and ``valid_metrics``. Runs
on card 0 (``RAT_TPU_PLATFORM=cpu`` or ``device="cpu"`` for the CPU).
"""

import argparse
import json
import logging
import os
import time

import numpy as np

from ..data.io import save_npy_atomic
from ..data.loader import DataGenerator
from ..engine import Trainer
from ..features import FeatureMap
from ..utils import load_config, seed_everything
from . import script_device
from .tmall_rehearsal import retrieval_configs


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--valid-rows", type=int, default=2_116_535)
    ap.add_argument("--expid", default="RAT_m2_tmall_x1_002_retrieval")
    ap.add_argument("--config", default="./configs/RAT_m2/tmall_x1_002")
    args = ap.parse_args(argv)
    device = script_device(device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    params = load_config(args.config, args.expid)
    params["epochs"] = 1
    seed_everything(params["seed"])
    data_dir = os.path.join(params["data_root"], params["dataset_id"])
    fm = FeatureMap(params["dataset_id"], data_dir)
    fm.load(os.path.join(data_dir, "feature_map.json"))

    stages, t_all = {}, time.time()

    def stage(name, t0):
        stages[name] = round(time.time() - t0, 1)
        logging.info("[stage] %s: %.1fs", name, stages[name])

    # the slice of the built valid split, as a split of its own with its
    # own retrieval cache
    slice_npy = os.path.join(data_dir, "valid_slice.npy")
    if not os.path.exists(slice_npy):
        valid = np.load(os.path.join(data_dir, "valid.npy"), mmap_mode="r")
        save_npy_atomic(np.array(valid[:args.valid_rows]), slice_npy)

    rc = retrieval_configs(params, fm)
    common = dict(batch_size=params["batch_size"], feature_map=fm, retrieval_configs=rc,
                  retrieval_pool_fname=os.path.join(data_dir, "retrieval_pool.npy"),
                  retrieval_augmented=True, device=device)

    t0 = time.time()
    train_gen = DataGenerator(data_path=os.path.join(data_dir, "train.npy"),
                              shuffle=True, **common)
    stage("train_retrieval_cache_load", t0)

    t0 = time.time()
    valid_gen = DataGenerator(data_path=slice_npy, shuffle=False, **common)
    stage("valid_slice_retrieval_{}_queries".format(args.valid_rows), t0)

    trainer = Trainer(fm, params, device=device)
    os.makedirs(trainer.model_dir, exist_ok=True)
    trainer.count_parameters()

    t0 = time.time()
    trainer.fit(train_gen, validation_data=valid_gen, epochs=1)
    stage("train_epoch_20M_incl_epoch_end_eval", t0)

    t0 = time.time()
    logs = trainer.evaluate(valid_gen, data=trainer._valid_data)
    stage("eval_{}_rows".format(args.valid_rows), t0)

    stages["total"] = round(time.time() - t_all, 1)
    stages["valid_metrics"] = {k: round(float(v), 6) for k, v in logs.items()}
    print("TMALL_REHEARSAL_TAIL " + json.dumps(stages), flush=True)
    return stages


if __name__ == "__main__":
    main()
