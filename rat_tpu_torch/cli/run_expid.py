"""Experiment entry point (port of rat_tpu.cli.run_expid).

    python -m rat_tpu_torch.cli.run_expid --config DIR --expid ID [--gpu N]
        [--mesh DATAxMODEL] [--platform cpu|gpu|auto]

Flow: load and merge the config -> set the logger -> seed -> build the
feature map and the ``.npy`` splits from the CSVs (or load the feature
map of ``data_format: h5`` data) -> retrieval-augmented generators (BM25
through kernel K2 on the card, results cached beside the splits) ->
model -> fit (kernel K1 per block with ``use_pallas``) -> reload the
best checkpoint -> valid and test evaluation -> append a line to
``<model_root>/<dataset_id>/<model_id>.csv``.

``--gpu N`` runs on ``cuda:N`` (default 0) and raises without that
device; ``--gpu -1`` asks for the CPU, where every kernel runs its
plain PyTorch version. ``--platform cpu`` (or RAT_TPU_PLATFORM=cpu)
asks for the CPU too, ``--platform gpu`` for CUDA.

``--mesh DATAxMODEL`` (or the config's ``mesh:`` key, or RAT_TPU_MESH)
runs over a mesh of DATA x MODEL processes (parallel/mesh.py): with no
process group yet, the command starts one worker per device itself,
rank r on ``cuda:N+r`` over NCCL, or every rank on the CPU over gloo
with ``--gpu -1``; under ``torchrun`` it joins the group torchrun
describes (rank r on ``cuda:N+LOCAL_RANK``). Asking for more CUDA
devices than there are raises. Rank 0 builds the dataset and writes the
caches, checkpoints, log and results line; the large-pool retrieval is
sharded over the mesh (``retrieval_configs`` get the mesh). With ``data_block_size`` the build writes
``<split>_part_N.npy`` blocks, which stream block by block through
retrieval, training and evaluation (``inter_block_retrieval: true`` in
the retrieval configs retrieves each train block from all the others).
The last log lines give the bytes of split arrays on the device at
once, the seconds of each stage (a blocked split's retrieval per
block; a build's ``build_csv_read``, ``build_fit``, ``build_transform``
and ``build_npy_write`` beside its total ``build``) and the launches of
each kernel in this run. A run that builds the dataset also logs
``Host encoder: {...}``: which encoder, ``native`` (the C++ extension
of rat_tpu_torch/native) or ``python``, encoded the categories, the
sequences and the token counts.
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
import torch.distributed as dist

from ..data import build_dataset, h5_generator
from ..engine import Trainer
from ..features import FeatureEncoder, FeatureMap
from ..features import datasets as dataset_encoders
from ..features.preprocess import encoders_run, reset_encoders_run
from ..ops import bm25_score_chunk, bm25_topk, cross_intra_block
from ..parallel import (from_rank0, initialize_distributed, launch, make_mesh,
                        mesh_axes, on_rank0)
from ..utils import (load_config, print_to_json, print_to_list, resolve_device,
                     seed_everything, set_logger)

_KERNELS = {"cross_intra_block": cross_intra_block, "bm25_topk": bm25_topk,
            "bm25_score_chunk": bm25_score_chunk}


def _platform_gpu(gpu, platform):
    """The device index the platform choice leaves: -1 for the CPU."""
    if platform == "auto":
        platform = os.environ.get("RAT_TPU_PLATFORM", "auto")
    if platform == "cpu":
        return -1
    if platform == "gpu":
        return max(gpu, 0)
    if platform != "auto":
        raise ValueError("platform={!r} (cpu, gpu or auto)".format(platform))
    return gpu


def _mesh_devices(n, gpu):
    if gpu < 0:
        return ["cpu"] * n
    if gpu + n > torch.cuda.device_count():
        raise RuntimeError("a mesh of {} ranks from cuda:{} needs {} CUDA devices; "
                           "{} present".format(n, gpu, gpu + n,
                                               torch.cuda.device_count()))
    return ["cuda:{}".format(gpu + r) for r in range(n)]


def _mesh_worker(config_dir, experiment_id, version, gpu, axes, results):
    out = run_experiment(config_dir, experiment_id, version, gpu, mesh=axes)
    if dist.get_rank() == 0:
        results.put(out)


def run_experiment(config_dir, experiment_id, version="torch", gpu=0,
                   platform="auto", mesh=None):
    """Run one experiment; returns (valid metrics, test metrics) (from
    rank 0 under a mesh). ``mesh``: a spec "DATAxMODEL" (or an int, or a
    (data, model) pair) overriding the config's ``mesh`` key and
    RAT_TPU_MESH; a mesh of one device is the single-device run."""
    gpu = _platform_gpu(gpu, platform)
    device = resolve_device("cpu" if gpu < 0 else "cuda:{}".format(gpu))
    params = load_config(config_dir, experiment_id)
    axes = tuple(mesh) if isinstance(mesh, (tuple, list)) else mesh_axes(params, mesh)
    n = 1 if axes is None else axes[0] * axes[1]
    if n > 1 and not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            # start one worker per device, each running this function
            import multiprocessing
            from . import run_expid
            # rank 0 puts two small metric dicts, which fit the pipe: its
            # put returns at once, so reading after the join cannot block
            results = multiprocessing.get_context("spawn").SimpleQueue()
            launch(run_expid._mesh_worker, _mesh_devices(n, gpu),
                   (config_dir, experiment_id, version, gpu, axes, results))
            return results.get()
        local = int(os.environ.get("LOCAL_RANK", 0))
        initialize_distributed("cpu" if gpu < 0 else "cuda:{}".format(gpu + local))
    device_mesh = None
    if n > 1:
        device_mesh = make_mesh(n, axes[1])
        device = device_mesh.device
    rank0 = device_mesh is None or device_mesh.rank == 0
    launches_before = {k: m.launches for k, m in _KERNELS.items()}
    stages = {}
    t_start = time.perf_counter()

    params["gpu"] = gpu
    params["version"] = version
    if rank0:
        set_logger(params)
    else:
        logging.getLogger().setLevel(logging.WARNING)
    logging.info(print_to_json(params))
    if device_mesh is not None:
        logging.info("Device mesh: {} ({} ranks on {})".format(
            device_mesh.shape, device_mesh.size, device.type))
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
        built = from_rank0(device_mesh, lambda: os.path.exists(feature_encoder.json_file))
        if not built:
            t0 = time.perf_counter()
            reset_encoders_run()
            split = {}
            on_rank0(device_mesh,
                     lambda: split.update(build_dataset(feature_encoder, **params)))
            stages["build"] = time.perf_counter() - t0
            stages.update(("build_" + k, v) for k, v in split.items())
            if rank0:
                logging.info("Host encoder: " + json.dumps(encoders_run()))
        if built or not rank0:
            feature_encoder.feature_map.load(feature_encoder.json_file)
        params["train_data"] = os.path.join(data_dir, "train*.npy")
        params["valid_data"] = os.path.join(data_dir, "valid*.npy")
        params["test_data"] = os.path.join(data_dir, "test*.npy")
        if "retrieval_configs" in params and \
                re.match(r"\d+-fold", params["retrieval_configs"]["split_type"]) is None:
            params["retrieval_configs"]["retrieval_pool_data"] = \
                os.path.join(data_dir, "retrieval_pool.npy")
        feature_map = feature_encoder.feature_map
    if device_mesh is not None and "retrieval_configs" in params:
        # the large-pool retrieval shards its pool over the mesh
        # (data/loader.py::_retrieve picks the engine by size)
        params["retrieval_configs"]["mesh"] = device_mesh

    train_gen, valid_gen = h5_generator(feature_map, stage="train", device=device,
                                        **params)
    test_gen = h5_generator(feature_map, stage="test", device=device, **params)
    # a blocked split retrieves block by block as it streams, filling
    # its retrieval_s dict during the run
    retrieval_s = {split + "_retrieval": gen.retrieval_s for split, gen in
                   (("train", train_gen), ("valid", valid_gen), ("test", test_gen))
                   if gen is not None}

    model = Trainer(feature_map, params, device=device, mesh=device_mesh)
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
    if rank0:
        os.makedirs(os.path.dirname(result_file), exist_ok=True)
        with open(result_file, "a+") as fw:
            fw.write(" {},[command] python {},[exp_id] {},[dataset_id] {},[train] {},"
                     "[val] {},[test] {}\n".format(
                         datetime.datetime.now().strftime("%Y%m%d-%H%M%S"),
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
                        help="CUDA device index (a mesh's first); -1 runs on the CPU.")
    parser.add_argument("--platform", type=str, default="auto",
                        choices=["auto", "cpu", "gpu"],
                        help="cpu forces the CPU, gpu CUDA; auto follows --gpu "
                             "(RAT_TPU_PLATFORM overrides auto).")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Device mesh 'DATAxMODEL' (e.g. 2x2) or an int for "
                             "pure data parallelism. Defaults to the config's "
                             "'mesh' key / RAT_TPU_MESH, else one device.")
    args = vars(parser.parse_args())
    run_experiment(args["config"], args["expid"], args["version"], args["gpu"],
                   args["platform"], args["mesh"])


if __name__ == "__main__":
    main()
