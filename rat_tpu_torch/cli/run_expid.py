"""Experiment entry point (port of rat_tpu.cli.run_expid).

    python -m rat_tpu_torch.cli.run_expid --config DIR --expid ID [--gpu N]

Flow: load and merge the config -> set the logger -> seed -> build the
feature map and the ``.npy`` splits from the CSVs (or load the feature
map of ``data_format: h5`` data) -> retrieval-augmented generators (BM25
through kernel K2 on the card, results cached beside the splits) ->
model -> fit (kernel K1 per block with ``use_pallas``) -> reload the
best checkpoint -> valid and test evaluation -> append a line to
``<model_root>/<dataset_id>/<model_id>.csv``.

``--gpu N`` runs on ``cuda:N`` (default 0) and raises without that
device; ``--gpu -1`` asks for the CPU, where every kernel runs its
plain PyTorch version. With ``data_block_size`` the build writes
``<split>_part_N.npy`` blocks, which stream block by block through
retrieval, training and evaluation (``inter_block_retrieval: true`` in
the retrieval configs retrieves each train block from all the others).
The last log lines give the bytes of split arrays on the device at
once, the seconds of each stage (a blocked split's retrieval per
block) and the launches of each kernel in this run.
"""

import argparse
import datetime
import gc
import json
import logging
import os
import re
import sys
import time

import torch

from ..data import build_dataset, h5_generator
from ..engine import Trainer
from ..features import FeatureEncoder, FeatureMap
from ..features import datasets as dataset_encoders
from ..ops import bm25_score_chunk, bm25_topk, cross_intra_block
from ..utils import (load_config, print_to_json, print_to_list, resolve_device,
                     seed_everything, set_logger)

_KERNELS = {"cross_intra_block": cross_intra_block, "bm25_topk": bm25_topk,
            "bm25_score_chunk": bm25_score_chunk}


def run_experiment(config_dir, experiment_id, version="torch", gpu=0):
    """Run one experiment; returns (valid metrics, test metrics)."""
    device = resolve_device("cpu" if gpu < 0 else "cuda:{}".format(gpu))
    launches_before = {k: m.launches for k, m in _KERNELS.items()}
    stages = {}
    t_start = time.perf_counter()

    params = load_config(config_dir, experiment_id)
    params["gpu"] = gpu
    params["version"] = version
    set_logger(params)
    logging.info(print_to_json(params))
    seed_everything(seed=params["seed"])

    dataset = params["dataset_id"].split("_")[0].lower()
    data_dir = os.path.join(params["data_root"], params["dataset_id"])
    if params.get("data_format") == "h5":
        feature_map = FeatureMap(params["dataset_id"], data_dir, params["version"])
        json_file = os.path.join(data_dir, "feature_map.json")
        if os.path.exists(json_file):
            feature_map.load(json_file)
        else:
            raise RuntimeError("feature_map not exist!")
    else:
        if hasattr(dataset_encoders, dataset):
            feature_encoder = getattr(dataset_encoders, dataset).FeatureEncoder(**params)
        else:
            feature_encoder = FeatureEncoder(**params)
        if os.path.exists(feature_encoder.json_file):
            feature_encoder.feature_map.load(feature_encoder.json_file)
        else:
            t0 = time.perf_counter()
            build_dataset(feature_encoder, **params)
            stages["build"] = time.perf_counter() - t0
        params["train_data"] = os.path.join(data_dir, "train*.npy")
        params["valid_data"] = os.path.join(data_dir, "valid*.npy")
        params["test_data"] = os.path.join(data_dir, "test*.npy")
        if "retrieval_configs" in params and \
                re.match(r"\d+-fold", params["retrieval_configs"]["split_type"]) is None:
            params["retrieval_configs"]["retrieval_pool_data"] = \
                os.path.join(data_dir, "retrieval_pool.npy")
        feature_map = feature_encoder.feature_map

    train_gen, valid_gen = h5_generator(feature_map, stage="train", device=device,
                                        **params)
    test_gen = h5_generator(feature_map, stage="test", device=device, **params)
    # a blocked split retrieves block by block as it streams, filling
    # its retrieval_s dict during the run
    retrieval_s = {split + "_retrieval": gen.retrieval_s for split, gen in
                   (("train", train_gen), ("valid", valid_gen), ("test", test_gen))
                   if gen is not None}

    model = Trainer(feature_map, params, device=device)
    model.count_parameters()
    model.fit(train_gen, validation_data=valid_gen, epochs=params["epochs"])
    stages["epochs"] = model.epoch_seconds

    logging.info("Load best model: {}".format(model.checkpoint))
    model.load_weights(model.checkpoint)

    t0 = time.perf_counter()
    logging.info("****** Validation evaluation ******")
    valid_result = model.evaluate(valid_gen)
    stages["valid_evaluation"] = time.perf_counter() - t0
    del train_gen
    gc.collect()

    t0 = time.perf_counter()
    logging.info("******** Test evaluation ********")
    test_result = {}
    if test_gen:
        test_result = model.evaluate(test_gen)
    stages["test_evaluation"] = time.perf_counter() - t0

    result_file = os.path.join(params["model_root"], params["dataset_id"],
                               params["model_id"] + ".csv")
    os.makedirs(os.path.dirname(result_file), exist_ok=True)
    with open(result_file, "a+") as fw:
        fw.write(" {},[command] python {},[exp_id] {},[dataset_id] {},[train] {},[val] {},[test] {}\n"
                 .format(datetime.datetime.now().strftime("%Y%m%d-%H%M%S"),
                         " ".join(sys.argv), experiment_id, params["dataset_id"],
                         "N.A.", print_to_list(valid_result),
                         print_to_list(test_result)))
    stages.update(retrieval_s)
    stages["total"] = time.perf_counter() - t_start
    logging.info("Device memory: " + json.dumps(
        {"peak_split_bytes": model.peak_split_bytes,
         "max_memory_allocated": torch.cuda.max_memory_allocated(device)
         if device.type == "cuda" else None}))
    logging.info("Stage seconds: " + json.dumps(stages))
    logging.info("Kernel launches: " + json.dumps(
        {k: m.launches - launches_before[k] for k, m in _KERNELS.items()}))
    return valid_result, test_result


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--version", type=str, default="torch",
                        help="The model version.")
    parser.add_argument("--config", type=str, default="./configs/",
                        help="The config directory.")
    parser.add_argument("--expid", type=str, default="RAT_m2_test",
                        help="The experiment id to run.")
    parser.add_argument("--gpu", type=int, default=0,
                        help="CUDA device index; -1 runs on the CPU.")
    args = vars(parser.parse_args())
    run_experiment(args["config"], args["expid"], args["version"], args["gpu"])


if __name__ == "__main__":
    main()
