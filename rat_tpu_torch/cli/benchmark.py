"""Benchmark harness (port of rat_tpu.cli.benchmark): train, eval and
retrieval throughput and data-parallel scaling, each as one JSON line
with the JAX package's metric names and keys (``metric``, ``value``,
``unit``, ``vs_baseline``), so that the two packages' lines compare.

Usage (on card 0; RAT_TPU_PLATFORM=cpu asks for the CPU):
  python -m rat_tpu_torch.cli.benchmark --bench train        # ML-Tag shape
  python -m rat_tpu_torch.cli.benchmark --bench train_pallas # fused path (K1)
  python -m rat_tpu_torch.cli.benchmark --bench eval
  python -m rat_tpu_torch.cli.benchmark --bench retrieval    # K2
  python -m rat_tpu_torch.cli.benchmark --bench scaling --devices 2
  python -m rat_tpu_torch.cli.benchmark --bench suite        # scaling over every card

The train bench times ``Trainer.train_step`` one step at a time. The
JAX package times groups of steps scanned into one dispatch
(``group``), which cuts JAX's per-dispatch cost; the port runs a plain
step loop, as its Trainer does, so there is no group. Every bench
runs on the card unless given ``device="cpu"``, and raises without a
card otherwise. ``--suite`` prints an error line for a bench that
raises and then exits non-zero; its scaling bench runs over every card
(``--devices`` to choose) and is printed as skipped below two.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..engine import Trainer
from ..features import FeatureMap
from ..retrieval import bm25_topk_retrieval
from ..utils import resolve_device

REF = {
    # retrieval: ML-Tag 10-fold precompute processes 1.4M queries against
    # ~1.26M-row fold pools; the reference gives no isolated number, so
    # vs_baseline is reported against the train-throughput baseline pool
    "retrieval": None,
}

# Workload shapes mirror the shipped reference experiment configs
# (configs/RAT_m2/*/model_config.yaml); vocab splits approximate each
# dataset's field cardinalities at the logged parameter counts
# (SURVEY.md §6). KKBox's two sequence fields are modeled as
# categoricals — the encoder/DNN compute they feed is shape-identical.
# ref_train/ref_eval: reference single-GPU examples/s from its logs.
SHAPES = {
    "mltag": {
        "fields": [("user_id", 61000), ("item_id", 17000),
                   ("tag_id", 12000)],
        "model": dict(embedding_dim=10, dnn_hidden_units=[400, 400, 400],
                      num_heads=2, dim_head=10, depth=4, scale_dim=4,
                      batch_norm=False, emb_dropout=0.0),
        "ref_train": 5.4e4, "ref_eval": 1.1e5,
    },
    "kkbox": {
        "fields": [("msno", 31000), ("song_id", 53000),
                   ("source_system_tab", 10), ("source_screen_name", 25),
                   ("source_type", 15), ("genre_ids", 3000),
                   ("artist_name", 17000), ("composer", 1000),
                   ("lyricist", 1000), ("language", 12), ("city", 25),
                   ("gender", 5), ("registered_via", 10)],
        "model": dict(embedding_dim=40, dnn_hidden_units=[400, 400, 400],
                      num_heads=8, dim_head=10, depth=4, scale_dim=2,
                      batch_norm=True, emb_dropout=0.1),
        "ref_train": 8.8e3, "ref_eval": 3.8e4,
    },
    "tmall": {
        "fields": [("user_id", 1000000), ("item_id", 570000),
                   ("cat_id", 2000), ("seller_id", 100000),
                   ("brand_id", 9000), ("age_range", 10), ("gender", 4),
                   ("weekday", 8), ("is_weekend", 3)],
        "model": dict(embedding_dim=10, dnn_hidden_units=[200, 80],
                      num_heads=32, dim_head=10, depth=4, scale_dim=2,
                      batch_norm=True, emb_dropout=0.0),
        "ref_train": 3.3e3, "ref_eval": 2.3e4,
    },
}

# The JAX package's exact-match bench divides by a rate of its own
# earlier implementation on its own accelerator; that is no baseline
# for this port, so its line carries vs_baseline null and says why.
_EXM_NOTE = ("no baseline: the JAX package's divisor is a rate of its own earlier "
             "implementation on another accelerator")


def _tag_ab_override(result):
    """Any run with RAT_AB_OVERRIDE set mutates model params; stamp the
    override into the result JSON so such a run is self-identifying and
    can never masquerade as a production number."""
    if os.environ.get("RAT_AB_OVERRIDE"):
        result["ab_override"] = os.environ["RAT_AB_OVERRIDE"]
    return result


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_feature_map(shape):
    cfg = SHAPES[shape]
    fm = FeatureMap("bench_" + shape, ".")
    fm.feature_specs = {
        name: {"source": "", "type": "categorical", "vocab_size": v,
               "index": i}
        for i, (name, v) in enumerate(cfg["fields"])}
    fm.num_fields = len(cfg["fields"])
    fm.num_features = sum(v for _, v in cfg["fields"])
    fm.input_length = fm.num_fields
    return fm


def bench_params(shape="mltag", use_pallas=False, batch_size=4096):
    """The JAX package's bench params for ``shape``, RAT_AB_OVERRIDE
    applied."""
    params = {
        "model": "RAT_m2", "model_id": "bench", "model_root": "./exps/bench/",
        "batch_size": batch_size,
        "dnn_activations": "relu", "dropout": 0.0,
        "net_dropout": 0.0, "use_wide": True,
        "embedding_regularizer": 0.03, "net_regularizer": 0,
        "learning_rate": 1e-3, "optimizer": "adam", "seed": 2021,
        "metrics": ["AUC", "logloss"], "use_pallas": use_pallas,
    }
    params.update(SHAPES[shape]["model"])
    if os.environ.get("RAT_AB_OVERRIDE"):
        # ablation hook: JSON model-param overrides, never set in
        # production runs
        params.update(json.loads(os.environ["RAT_AB_OVERRIDE"]))
    return params


def bench_arrays(shape="mltag", batch_size=4096, n_idx=16, n_rows=200_000):
    """The bench's host arrays, drawn from RandomState(0) in the JAX
    package's order: tokens field by field, labels, neighbours, then the
    index batches. Returns (tokens int32 [N, F], labels float32 [N],
    nbr int32 [N, K], [idx int32 [B]] * n_idx)."""
    fields = SHAPES[shape]["fields"]
    B, K, N = batch_size, 5, n_rows
    rng = np.random.RandomState(0)
    tokens = np.stack([rng.randint(0, v, N) for _, v in fields],
                      axis=1).astype(np.int32)
    labels = rng.randint(0, 2, N).astype(np.float32)
    nbr = rng.randint(0, N, (N, K)).astype(np.int32)
    idx = [rng.randint(0, N, B).astype(np.int32) for _ in range(n_idx)]
    return tokens, labels, nbr, idx


def _bench_setup(shape="mltag", use_pallas=False, batch_size=4096, n_idx=16,
                 n_rows=200_000, device=None):
    """(trainer, split on the device, index batches on the device, B).
    The split is the device-resident dict ``_gather_batch`` reads; the
    pool is the split itself."""
    device = resolve_device(device)
    trainer = Trainer(_bench_feature_map(shape),
                      bench_params(shape, use_pallas, batch_size), device=device)
    tokens, labels, nbr, idx = bench_arrays(shape, batch_size, n_idx, n_rows)
    tokens = torch.from_numpy(tokens.astype(np.int64)).to(device)
    labels = torch.from_numpy(labels).to(device)
    data = {"tokens": tokens, "labels": labels, "pool_tokens": tokens,
            "pool_labels": labels,
            "nbr": torch.from_numpy(nbr.astype(np.int64)).to(device)}
    idx = [torch.from_numpy(i.astype(np.int64)).to(device) for i in idx]
    return trainer, data, idx, batch_size


def bench_train(use_pallas=False, steps=512, warmup=64, shape="mltag",
                batch_size=4096, n_rows=200_000, device=None):
    """Examples/s of the train step (loss, backward, clip, Adam) over
    the 16 index batches in turn: ``warmup`` steps, then the best of 3
    windows of ``steps`` steps, each ended by a synchronize and a
    ``.item()`` of its last loss."""
    trainer, data, idx, B = _bench_setup(shape, use_pallas, batch_size,
                                         n_rows=n_rows, device=device)
    dev = trainer.device
    for i in range(warmup):
        loss = trainer.train_step(data, idx[i % len(idx)], B)
    _sync(dev)
    if warmup:
        float(loss.item())
    rates = []
    for _ in range(3):
        tic = time.perf_counter()
        for i in range(steps):
            loss = trainer.train_step(data, idx[i % len(idx)], B)
        _sync(dev)
        float(loss.item())
        rates.append(steps * B / (time.perf_counter() - tic))
    eps = max(rates)
    name = "rat_m2_{}_train_throughput{}".format(
        shape, "_pallas" if use_pallas else "")
    return _tag_ab_override(
        {"metric": name, "value": round(eps, 1), "unit": "examples/s",
         "vs_baseline": round(eps / SHAPES[shape]["ref_train"], 3)})


@torch.no_grad()
def bench_eval(steps=100, shape="mltag", batch_size=4096, n_rows=200_000, device=None):
    """Examples/s of the eval forward, one DISTINCT index batch per step
    (as in the JAX package, whose remote runtime could serve a repeated
    batch from a cache)."""
    trainer, data, idx, B = _bench_setup(shape, batch_size=batch_size, n_idx=steps,
                                         n_rows=n_rows, device=device)
    trainer.model.eval()
    dev = trainer.device
    float(trainer._forward(data, idx[0])["y_pred"][0].item())
    tic = time.perf_counter()
    for i in range(steps):
        out = trainer._forward(data, idx[i])
    _sync(dev)
    float(out["y_pred"][0].item())
    eps = steps * B / (time.perf_counter() - tic)
    return _tag_ab_override(
        {"metric": "rat_m2_{}_eval_throughput".format(shape),
         "value": round(eps, 1), "unit": "examples/s",
         "vs_baseline": round(eps / SHAPES[shape]["ref_eval"], 3)})


def retrieval_arrays(n_db=200_000, n_qry=100_000):
    """The BM25 bench's pool [n_db, 3] and queries [n_qry, 3] (pool rows
    drawn again), from RandomState(0) at ML-Tag's vocabularies."""
    rng = np.random.RandomState(0)
    db = np.stack([rng.randint(0, 61000, n_db), rng.randint(0, 17000, n_db),
                   rng.randint(0, 12000, n_db)], axis=1)
    return db, db[rng.randint(0, n_db, n_qry)]


#: the BM25 bench's retrieval arguments besides the arrays and device
RETRIEVAL_KW = dict(qry_batch_size=2048, db_chunk_size=50_000)


def bench_retrieval(n_db=200_000, n_qry=100_000, topk=5, device=None):
    """Queries/s of BM25 retrieval (K2 on the card) over an ML-Tag-shaped
    pool; vs_baseline is billions of row scores per second."""
    db, q = retrieval_arrays(n_db, n_qry)
    kw = dict(RETRIEVAL_KW, topK=topk, device=device)
    bm25_topk_retrieval(db, q, **kw)         # warm: the kernels' first launches
    tic = time.perf_counter()
    bm25_topk_retrieval(db, q, **kw)         # returns host arrays: synced
    secs = time.perf_counter() - tic
    qps = n_qry / secs
    row_scores = qps * n_db
    return {"metric": "bm25_retrieval_queries_per_s_200k_pool",
            "value": round(qps, 1), "unit": "queries/s",
            "vs_baseline": round(row_scores / 1e9, 3)}  # billion row-scores/s


def bench_retrieval_exm(n_db=200_000, n_qry=100_000, topk=5, device=None):
    """Exact-match retrieval: a low-cardinality exact column (8 keys,
    ~25k-row candidate windows) and 3 scored columns."""
    rng = np.random.RandomState(0)
    db = np.stack([rng.randint(0, 8, n_db),
                   rng.randint(0, 61000, n_db),
                   rng.randint(0, 17000, n_db),
                   rng.randint(0, 12000, n_db)], axis=1)
    q = db[rng.randint(0, n_db, n_qry)]
    kw = dict(exact_match_col_indices=[0], qry_batch_size=2048, topK=topk,
              device=device)
    bm25_topk_retrieval(db, q[:4096], **kw)          # warm
    tic = time.perf_counter()
    bm25_topk_retrieval(db, q, **kw)
    qps = n_qry / (time.perf_counter() - tic)
    return {"metric": "bm25_exact_match_queries_per_s_200k_pool",
            "value": round(qps, 1), "unit": "queries/s",
            "vs_baseline": None, "note": _EXM_NOTE}


def _scaling_params():
    return {"model": "RAT_m2", "model_id": "bench", "model_root": "./exps/bench/",
            "embedding_dim": 10, "dnn_hidden_units": [64, 64],
            "dnn_activations": "relu", "num_heads": 2, "dim_head": 10, "depth": 2,
            "scale_dim": 4, "dropout": 0., "emb_dropout": 0., "net_dropout": 0.,
            "batch_norm": False, "use_wide": True, "embedding_regularizer": 0.03,
            "net_regularizer": 0, "learning_rate": 1e-3, "optimizer": "adam",
            "seed": 2021, "metrics": ["AUC"]}


def _steps_per_s(trainer, data, idx, steps):
    B = len(idx)
    trainer.train_step(data, idx, B)
    _sync(trainer.device)
    tic = time.perf_counter()
    for _ in range(steps):
        loss = trainer.train_step(data, idx, B)
    float(loss.item())
    return steps * B / (time.perf_counter() - tic)


def _scaling_on_group(steps=20, per_device=1024, n_rows=50_000):
    """The scaling bench on this rank of the current process group (all
    ranks call it). Rank 0 first runs the single-device baseline (a
    Trainer without a mesh; the other ranks wait), then every rank runs
    the data-parallel mesh over the whole world. Both take their first
    step on the same global batch from the same initial weights, so the
    two losses must agree; the baseline's rate is timed at one device's
    batch, the mesh's at the global one. Returns the result line."""
    from ..parallel import make_mesh
    from ..parallel.distributed import process_device
    n = dist.get_world_size()
    device = process_device()
    mesh = make_mesh(n, 1)
    fm = _bench_feature_map("mltag")
    B, K = per_device * n, 5
    rng = np.random.RandomState(0)
    tokens = np.stack([rng.randint(0, 61000, n_rows), rng.randint(0, 17000, n_rows),
                       rng.randint(0, 12000, n_rows)], axis=1)
    labels = rng.randint(0, 2, n_rows).astype(np.float32)
    nbr = rng.randint(0, n_rows, (n_rows, K))
    idx = torch.from_numpy(rng.randint(0, n_rows, B)).to(device)
    tokens = torch.from_numpy(tokens).to(device)
    labels = torch.from_numpy(labels).to(device)
    data = {"tokens": tokens, "labels": labels, "pool_tokens": tokens,
            "pool_labels": labels, "nbr": torch.from_numpy(nbr).to(device)}
    base = None
    if mesh.rank == 0:
        single = Trainer(fm, _scaling_params(), device=device)
        base = (float(single.train_step(data, idx, B)),
                _steps_per_s(single, data, idx[:per_device], steps))
        del single
    base = mesh.broadcast(base)
    trainer = Trainer(fm, _scaling_params(), mesh=mesh)
    loss = float(trainer.train_step(data, idx, B))
    rate = _steps_per_s(trainer, data, idx, steps)
    loss_ok = bool(np.isfinite(loss) and np.isfinite(base[0])
                   and abs(loss - base[0]) <= 1e-5 * max(1.0, abs(base[0])))
    if device.type != "cuda":
        # CPU ranks share the host's cores: a rate is a host artifact,
        # not scaling, so only correctness is reported
        return {"metric": "spmd_correctness_{}dev".format(n),
                "value": 1.0 if loss_ok else 0.0, "unit": "bool",
                "vs_baseline": 1.0 if loss_ok else 0.0,
                "note": "CPU ranks: correctness only (the mesh's first loss against "
                        "one device's on the same global batch); efficiency is only "
                        "measured on cards"}
    eff = rate / (base[1] * n)
    return {"metric": "dp_scaling_efficiency_{}dev".format(n),
            "value": round(eff, 3), "unit": "fraction",
            "vs_baseline": round(eff / 0.8, 3),  # >= 80% target
            "loss_equal_to_one_device": loss_ok}


def _scaling_worker(steps, per_device, n_rows, results):
    out = _scaling_on_group(steps, per_device, n_rows)
    if dist.get_rank() == 0:
        results.put(out)


def bench_scaling(n_devices, device=None, steps=20, per_device=1024, n_rows=50_000):
    """Data-parallel scaling over ``n_devices`` ranks, one card each
    (NCCL), spawned here; raises when there are fewer cards. With
    ``device="cpu"``, gloo ranks on the CPU report correctness only."""
    if n_devices < 2:
        raise ValueError("bench_scaling needs at least 2 ranks, got {}".format(n_devices))
    import multiprocessing

    from ..parallel import launch
    if device is None or torch.device(device).type == "cuda":
        resolve_device(device)
        if n_devices > torch.cuda.device_count():
            raise RuntimeError("{} ranks need {} CUDA devices, {} present".format(
                n_devices, n_devices, torch.cuda.device_count()))
        devices = ["cuda:{}".format(r) for r in range(n_devices)]
    else:
        devices = ["cpu"] * n_devices
    results = multiprocessing.get_context("spawn").SimpleQueue()
    launch(_scaling_worker, devices, (steps, per_device, n_rows, results))
    return results.get()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--bench", default="train",
                        choices=["train", "train_pallas", "eval", "retrieval",
                                 "retrieval_exm", "scaling", "suite"])
    parser.add_argument("--devices", type=int, default=None,
                        help="scaling ranks (default: every card; 2 on the CPU)")
    parser.add_argument("--shape", default="mltag", choices=sorted(SHAPES))
    parser.add_argument("--steps", type=int, default=0,
                        help="train-bench steps override (0 = default)")
    args = parser.parse_args(argv)
    device = "cpu" if os.environ.get("RAT_TPU_PLATFORM") == "cpu" else None
    tsteps = dict(steps=args.steps) if args.steps else {}
    n_devices = args.devices if args.devices is not None else (
        2 if device == "cpu" else torch.cuda.device_count())
    benches = {
        "train": lambda: bench_train(False, shape=args.shape, device=device, **tsteps),
        "train_pallas": lambda: bench_train(True, shape=args.shape, device=device,
                                            **tsteps),
        "eval": lambda: bench_eval(shape=args.shape, device=device),
        "retrieval": lambda: bench_retrieval(device=device),
        "retrieval_exm": lambda: bench_retrieval_exm(device=device),
        "scaling": lambda: bench_scaling(n_devices, device=device),
    }
    if args.bench != "suite":
        print(json.dumps(benches[args.bench]()), flush=True)
        return 0
    failed = 0
    for name, fn in benches.items():
        if name == "scaling" and n_devices < 2:
            # one card has no scaling to measure: not a failure
            print(json.dumps({"metric": name, "skipped": "needs at least 2 cards, {} "
                              "present".format(n_devices)}), flush=True)
            continue
        try:
            print(json.dumps(fn()), flush=True)
        except Exception as e:
            failed += 1
            print(json.dumps({"metric": name, "error": str(e)[:200]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
