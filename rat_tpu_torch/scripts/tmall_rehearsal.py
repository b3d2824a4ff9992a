"""Tmall-scale rehearsal: every stage of the composed pipeline of
configs/RAT_m2/tmall_x1_002, timed.

Synthetic 20M/21M/20M-row CSVs (train, test, an explicit retrieval
pool) -> the feature build (encoder fit on train + pool) -> BM25
retrieval of the train split's and the valid split's neighbours against
the pool (kernel K2, ``qry_batch_size`` queries per launch) -> one
training epoch with its epoch-end evaluation -> a standalone evaluation
of the valid split. The config is the shipped
RAT_m2_tmall_x1_002_retrieval expid (explicit pool file, sequential
split) with ``epochs: 1``; the valid file is the test file, so the test
split is not built and the valid split is evaluated once more.

    python -m rat_tpu_torch.scripts.tmall_rehearsal              # full scale
    python -m rat_tpu_torch.scripts.tmall_rehearsal --scale 0.03 # 1/33

Paths are relative to the working directory: the CSVs go to
``./data/tmall[_s<scale>]``, the build to the config's ``data_root``.
The build writes the port's ``.npy`` splits and ``.npz`` retrieval
caches; its stage keeps the JAX script's name, ``build_csv_to_h5``, so
that the two lines compare. A second run reuses the CSVs, the build and
the caches. The last line is ``TMALL_REHEARSAL {json}``: seconds per
stage, ``total``, ``scale`` and ``valid_metrics``. Runs on card 0
(``RAT_TPU_PLATFORM=cpu`` or ``device="cpu"`` for the CPU).
"""

import argparse
import json
import logging
import os
import time

from ..data.build import build_dataset
from ..data.loader import DataGenerator
from ..data.synthetic import make_tmall_like
from ..engine import Trainer
from ..features import FeatureEncoder
from ..utils import load_config, seed_everything
from . import script_device

#: Tmall's published row counts (train, test, retrieval pool)
FULL_ROWS = (20_038_830, 21_165_358, 20_000_000)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count multiplier (1.0 = full Tmall scale)")
    ap.add_argument("--expid", default="RAT_m2_tmall_x1_002_retrieval")
    ap.add_argument("--config", default="./configs/RAT_m2/tmall_x1_002")
    return ap.parse_args(argv)


def retrieval_configs(params, fm):
    """The config's retrieval settings with the retrieval columns' slots."""
    rc = dict(params["retrieval_configs"])
    rc["used_col_indices"] = [fm.feature_specs[c]["index"] for c in rc["used_cols"]]
    rc["exact_match_col_indices"] = None
    return rc


def main(argv=None, device=None):
    args = _args(argv)
    device = script_device(device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    s = args.scale
    tag = "" if s == 1.0 else "_s{:g}".format(s)
    data_src = "./data/tmall{}".format(tag)
    stages, t_all = {}, time.time()

    def stage(name, t0):
        stages[name] = round(time.time() - t0, 1)
        logging.info("[stage] %s: %.1fs", name, stages[name])

    params = load_config(args.config, args.expid)
    params["dataset_id"] = params["dataset_id"] + tag
    params["epochs"] = 1
    for key in ("train_data", "valid_data", "test_data"):
        params[key] = os.path.join(data_src, os.path.basename(params[key]))
    params["retrieval_configs"]["retrieval_pool_data"] = os.path.join(
        data_src, "retrieval_pool.csv")
    seed_everything(params["seed"])

    t0 = time.time()
    if not os.path.exists(os.path.join(data_src, "retrieval_pool.csv")):
        n_train, n_test, n_pool = (int(n * s) for n in FULL_ROWS)
        make_tmall_like(data_src, n_train=n_train, n_test=n_test, n_pool=n_pool,
                        seed=11)
    stage("generate_csv", t0)

    data_dir = os.path.join(params["data_root"], params["dataset_id"])
    t0 = time.time()
    feature_encoder = FeatureEncoder(**params)
    if os.path.exists(feature_encoder.json_file):
        feature_encoder.feature_map.load(feature_encoder.json_file)
    else:
        build_dataset(feature_encoder,
                      train_data=params["train_data"],
                      valid_data=params["valid_data"],
                      test_data=None,  # test == valid file; eval once
                      retrieval_configs=params["retrieval_configs"],
                      **{k: v for k, v in params.items()
                         if k not in ("train_data", "valid_data",
                                      "test_data", "retrieval_configs")})
    fm = feature_encoder.feature_map
    stage("build_csv_to_h5", t0)

    rc = retrieval_configs(params, fm)
    pool = os.path.join(data_dir, "retrieval_pool.npy")
    common = dict(batch_size=params["batch_size"], feature_map=fm, retrieval_configs=rc,
                  retrieval_pool_fname=pool, retrieval_augmented=True, device=device)

    t0 = time.time()
    train_gen = DataGenerator(data_path=os.path.join(data_dir, "train.npy"),
                              shuffle=True, **common)
    stage("train_retrieval_20M_queries", t0)

    t0 = time.time()
    valid_gen = DataGenerator(data_path=os.path.join(data_dir, "valid.npy"),
                              shuffle=False, **common)
    stage("valid_retrieval_21M_queries", t0)

    # the valid split stays on the host during the train epoch and is
    # uploaded for each evaluation, as in the JAX script
    params["lazy_valid_upload"] = True
    trainer = Trainer(fm, params, device=device)
    os.makedirs(trainer.model_dir, exist_ok=True)
    trainer.count_parameters()

    t0 = time.time()
    trainer.fit(train_gen, validation_data=valid_gen, epochs=1)
    stage("train_epoch_incl_epoch_end_eval", t0)

    t0 = time.time()
    logs = trainer.evaluate(valid_gen, data=trainer._valid_data)
    stage("eval_21M_rows", t0)

    stages["total"] = round(time.time() - t_all, 1)
    stages["scale"] = s
    stages["valid_metrics"] = {k: round(float(v), 6) for k, v in logs.items()}
    print("TMALL_REHEARSAL " + json.dumps(stages), flush=True)
    return stages


if __name__ == "__main__":
    main()
