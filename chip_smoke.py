"""Smoke run of rat_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, any failure exits non-zero:

1. build   — compile the CUDA kernels of rat_tpu_torch/csrc/ into
             build/kernels/ (one nvcc per source, in parallel); fails if
             ptxas reports spill stores in a K1 or K2 kernel, and prints
             the registers and CTAs per SM of the main path's K1 and K2.
2. kernels — hold each kernel against its plain PyTorch version on the
             card: K1 (fused cross/intra block) at the ML-Tag, KKBox and
             Tmall block shapes, heads=1/dim_head=d at d=10 and d=40 and
             d=16/dim_head=8 (the last two run its kernel for widths
             other than the configs'), rtol 1e-4 / atol 1e-5; K2 (BM25
             score + top-K) exactly, after the zero-score drop, on
             tie-heavy pools, K above the pool size and 4096 and 5000
             queries against the serving pool; K3 (dense BM25 chunk
             scores) exactly (torch.equal) at 4096 requests x
             50,000 pool rows, F=11 with ragged B and C, heavy ties and
             F=16. Each kernel is timed on the device (torch.profiler's
             kernel time, ``ms``; K1 at every shape, K2 at 4096 queries
             and at the main path's 5000) and with CUDA events around
             back-to-back calls of its wrapper (``call_ms``), its plain
             version with CUDA events.
3. K1 grad — K1 under autograd (ops.cross_intra_block.CrossIntraBlock):
             dx and the 14 weight gradients against autograd of the
             plain version at the ML-Tag (B=4096 and 4093), KKBox and
             heads=1/dim_head=d (d=10 and d=40) shapes, rtol 2e-3 /
             atol 1e-4;
             forward+backward timed for both.
4. serve   — RAT_m2 at the full width of the ML-Tag config
             (configs/RAT_m2/movielenslatest_x1, plus use_pallas) on
             ML-Tag-shaped data made from the seed: a ~1.4M-row pool,
             ~0.2M requests retrieved by BM25 through K2, then scored by
             Trainer.evaluate through K1, with seeded random weights.
             Launch counts are zeroed before and read after this phase.
5. profile — one more pass of serving under torch.profiler: device
             time by kernel, and the device's idle share.
6. train   — the same config trained as a user drives it: the ~1.4M
             rows as the train split with 10-fold self-retrieval (K2),
             the ~0.2M rows as the valid split retrieved against it,
             a one-step check (the fused step's loss and gradients
             against the module path's), then Trainer.fit for one epoch
             (K1 forward in every step and every eval batch), the
             reload of the best checkpoint, and asserted launch counts.
7. train profile — 20 more train steps timed, then under
             torch.profiler: device time by kernel, K1's forward
             against the autograd backward of the block, idle share.
8. kkbox_train — RAT_m2 at the full width of the KKBox config
             (configs/RAT_m2/kkbox_x1: d=40, 8 heads, BatchNorm,
             embedding dropout, two sequence fields, the wide tower) on
             KKBox-shaped data made from the seed, its rows cut for
             chip time: 10-fold self-retrieval over the 11 retrieval
             fields (K2 at F=11), one epoch of Trainer.fit on the module
             path (the gate keeps K1 off), the reload, K2's neighbours
             and the card's eval logits held against plain and CPU
             runs, K2 at F=11 held to its plain version and timed at
             the valid split's 2400-query batch, then a short profile
             and the step's device-time split.
9. variants — RAT_m0, RAT_m1 and RAT_m3 at the full widths of their
             ML-Tag configs on the train phase's data and neighbours:
             one step on the card against the same step on the CPU,
             one epoch of Trainer.fit, the reload, steady ms per step
             and a short profile (device time per step, idle share).

The line before the last is the kernel table as JSON; the last line
says the run was ok, and names the device. Without CUDA the script
exits non-zero before printing either.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rat_tpu_torch.data.loader import DataGenerator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.trainer import _gather_batch
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.models import build_model
from rat_tpu_torch.ops import _build
from rat_tpu_torch.ops import bm25_score_chunk as k3
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1
from rat_tpu_torch.retrieval import bm25

# RAT_m2_movielenslatest_x1_10fold_retrieval at its published widths
# and training settings (configs/RAT_m2/movielenslatest_x1/
# model_config.yaml), plus the fused kernel path switch. The train phase
# sets model_root to a temporary directory.
MLTAG_PARAMS = {
    "model": "RAT_m2", "model_id": "RAT_m2_movielenslatest_x1_10fold_retrieval",
    "dataset_id": "movielenslatest_x1_10fold_retrieval", "model_root": None,
    "embedding_dim": 10, "num_heads": 2, "dim_head": 10, "depth": 4,
    "scale_dim": 4, "dnn_hidden_units": [400, 400, 400],
    "dnn_activations": "relu", "use_wide": True, "batch_norm": False,
    "dropout": 0.0, "emb_dropout": 0.0, "net_dropout": 0.0,
    "batch_size": 4096, "metrics": ["AUC", "logloss"], "seed": 2021,
    "embedding_regularizer": 0.03, "learning_rate": 1e-3, "optimizer": "adam",
    "loss": "binary_crossentropy", "monitor": "AUC", "monitor_mode": "max",
    "patience": 2, "every_x_epochs": 1, "save_best_only": True,
    "use_pallas": True,
}
# the dataset's retrieval block (dataset_config.yaml)
MLTAG_RETRIEVAL = {
    "used_cols": ["user_id", "item_id", "tag_id"], "exact_match_cols": [],
    "split_type": "10-fold", "label_wise": False, "pre_retrieval": True,
    "qry_batch_size": 5000, "db_chunk_size": 50000, "topK": 5,
    "used_col_indices": [0, 1, 2], "exact_match_col_indices": None,
}
# ML-Tag (MovielensLatest_x1) holds ~90k ids over its three fields and
# 1,404,801 / 200,686 train / test rows; id 0 is left for the encoder's
# out-of-vocabulary slot
MLTAG_VOCAB = {"user_id": 16_973, "item_id": 23_745, "tag_id": 49_659}
MLTAG_POOL_ROWS = 1_404_801
MLTAG_TEST_ROWS = 200_686

# RAT_m2_kkbox_x1_10fold_retrieval at its published widths and training
# settings (configs/RAT_m2/kkbox_x1/model_config.yaml), plus the fused
# kernel path switch, which the JAX gate turns off for this config
# (BatchNorm, embedding dropout)
KKBOX_PARAMS = dict(MLTAG_PARAMS, **{
    "model_id": "RAT_m2_kkbox_x1_10fold_retrieval",
    "dataset_id": "kkbox_x1_10fold_retrieval",
    "embedding_dim": 40, "num_heads": 8, "dim_head": 10, "depth": 4, "scale_dim": 2,
    "batch_norm": True, "emb_dropout": 0.1, "embedding_regularizer": 0.0005})
# the dataset's fields in column order (configs/RAT_m2/kkbox_x1/
# dataset_config.yaml): vocabulary sizes chosen so the packed table holds
# ~92K rows, which at d=40 gives the real set's parameter count
# (4,714,649, BASELINE.md) within a few percent; the two sequence fields
# are 3 long, MaskedSumPooling, padded with id vocab - 1
KKBOX_VOCAB = {"msno": 25_000, "song_id": 54_000, "source_system_tab": 10,
               "source_screen_name": 21, "source_type": 13, "city": 22, "gender": 4,
               "registered_via": 6, "language": 11, "genre_ids": 350,
               "artist_name": 12_000, "isrc": 110, "bd": 10}
KKBOX_SEQUENCES = ("genre_ids", "artist_name")
KKBOX_RETRIEVAL = {
    "used_cols": ["msno", "song_id", "source_system_tab", "source_screen_name",
                  "source_type", "city", "gender", "registered_via", "language",
                  "isrc", "bd"],
    "exact_match_cols": [], "split_type": "10-fold", "label_wise": False,
    "pre_retrieval": True, "qry_batch_size": 2400, "db_chunk_size": 50000, "topK": 5,
    "exact_match_col_indices": None,
}
# rows cut for chip time only: the real split has 5,901,932 train and
# 737,743 valid rows (BASELINE.md); 409,600 rows are 100 steps of 4096
KKBOX_TRAIN_ROWS = 409_600
KKBOX_VALID_ROWS = 51_200

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def mltag_feature_map():
    fm = FeatureMap("movielenslatest_x1_10fold_retrieval", ".")
    for i, (name, vocab) in enumerate(MLTAG_VOCAB.items()):
        fm.feature_specs[name] = {"source": "", "type": "categorical",
                                  "vocab_size": vocab, "index": i}
    fm.num_fields = len(MLTAG_VOCAB)
    fm.num_features = sum(MLTAG_VOCAB.values())
    fm.input_length = len(MLTAG_VOCAB)
    return fm


def mltag_arrays(seed, n_pool, n_test, vocab=None, zipf_a=1.05):
    """(pool [n_pool, 4], test [n_test, 4]) float64 rows of three ids and
    a 0/1 label. Each field's ids follow a Zipf law over its vocabulary,
    as interaction logs do, so matches and ties are frequent; labels
    come from latent per-id propensities (about a third positive)."""
    rng = np.random.RandomState(seed)
    vocab = vocab or MLTAG_VOCAB
    n = n_pool + n_test
    cols, logit = [], np.full(n, -0.7)
    for size in vocab.values():
        p = 1.0 / np.arange(1, size) ** zipf_a
        ids = 1 + rng.choice(size - 1, n, p=p / p.sum())
        cols.append(ids)
        logit += rng.normal(0, 0.8, size)[ids]
    label = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))
    rows = np.stack(cols + [label], axis=1).astype(np.float64)
    return rows[:n_pool], rows[n_pool:]


def _serve_path(device, seed, pool, test, batch_size):
    """The main path as a user drives it: a DataGenerator retrieves every
    request's neighbours from the pool (K2 on a GPU), then
    Trainer.evaluate scores them through rat_m2_fast_forward (K1 per
    block). Returns (gen, trainer, data, logs, timings in ms)."""
    fm = mltag_feature_map()
    params = dict(MLTAG_PARAMS, batch_size=batch_size, seed=seed)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    gen = DataGenerator(data_array=test, pool_array=pool, batch_size=batch_size,
                        feature_map=fm, retrieval_configs=dict(MLTAG_RETRIEVAL),
                        retrieval_pool_fname="mltag_pool",
                        retrieval_augmented=True, device=device)
    sync()
    t1 = time.perf_counter()
    trainer = Trainer(fm, params, device=device)
    data = trainer.device_split(gen)
    sync()
    t2 = time.perf_counter()
    logs = trainer.evaluate(gen, data)
    sync()
    t3 = time.perf_counter()
    return gen, trainer, data, logs, {"retrieval_ms": (t1 - t0) * 1e3,
                                      "upload_ms": (t2 - t1) * 1e3,
                                      "scoring_ms": (t3 - t2) * 1e3}


def check_neighbours(gen, pool, queries, retrieval, device, phase, n_chk=512):
    """The first ``n_chk`` queries' neighbours, scores and counts in
    ``gen`` (retrieved from ``pool``) against the plain scan's, exactly."""
    n_chk = min(n_chk, len(queries))
    K = retrieval["topK"]
    used = retrieval["used_col_indices"]
    tables = bm25._compute_idf_tables(pool[:, used].astype(np.int64))
    db_T = torch.zeros((len(used), max(len(pool), K)), dtype=torch.int32,
                       device=device)
    db_T[:, :len(pool)] = torch.from_numpy(pool[:, used].T.astype(np.int32)).to(device)
    q = torch.from_numpy(np.ascontiguousarray(queries[:n_chk, used],
                                              dtype=np.int32)).to(device)
    idf = bm25._idf_lookup_dense(q, *bm25._pack_idf_dense(tables, device))
    v, i, lens = bm25._finalize(*k2.bm25_topk_reference(q, idf.contiguous(), db_T,
                                                       len(pool), K), False)
    for got, want in ((gen.retr_indices[:n_chk], i), (gen.retr_values[:n_chk], v),
                      (gen.retr_lens[:n_chk], lens)):
        if not np.array_equal(got, want.cpu().numpy().astype(got.dtype)):
            raise AssertionError(phase + ": retrieval differs from the plain scan")
    return n_chk


def serve(device, seed, pool, test, batch_size):
    """Run the main path with the launch counts zeroed just before and
    read just after, then check its outputs: finite predictions in
    [0, 1], and on the first requests the plain scan's neighbours and
    the module forward's scores. Returns a dict of results."""
    k1.launches = k2.launches = 0
    gen, trainer, data, logs, times = _serve_path(device, seed, pool, test,
                                                  batch_size)
    launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches}

    y_pred = trainer.predict(gen, data)
    if y_pred.shape != (len(test),) or not np.all(np.isfinite(y_pred)) \
            or y_pred.min() < 0 or y_pred.max() > 1:
        raise AssertionError("serve: predictions of bad shape or range")
    check_neighbours(gen, pool, test, MLTAG_RETRIEVAL, device, "serve")
    X, y, _, _ = _gather_batch(data, torch.arange(min(batch_size, len(test)),
                                                  device=device))
    with torch.no_grad():
        plain = trainer.model(X, y)["y_pred"][:, 0].cpu().numpy()
    plain_err = float(np.abs(plain - y_pred[:len(plain)]).max())
    if plain_err > 1e-5:
        raise AssertionError("serve: fused path differs from the module "
                             "forward by {}".format(plain_err))
    return dict({"requests": len(test), "pool_rows": len(pool),
                 "batches": gen.num_batches, "depth": trainer.model.depth},
                **times,
                scoring_examples_per_s=len(test) / times["scoring_ms"] * 1e3,
                AUC=logs["AUC"], logloss=logs["logloss"],
                fused_vs_module_max_abs_err=plain_err, launches=launches)


def _device_events(events):
    """The profiler's kernels and copies on the device, without the
    device-side ranges of user annotations (such as Optimizer.step),
    which span kernels that are counted already."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profile_serve(device, seed, pool, test, batch_size, rows=15):
    """Device time by kernel over one more pass of the main path
    (torch.profiler), and the device's busy and idle share of it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _serve_path(device, seed, pool, test, batch_size)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_events(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print("profile: wall {:.3f} ms, device busy {:.3f} ms, idle share {:.4f}".format(
        wall_ms, busy_ms, 1 - busy_ms / wall_ms))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]:
        print("profile: {:10.3f} ms {:6d} calls  {}".format(
            e.self_device_time_total / 1e3, e.count, e.key[:100]))


def _cuda_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps, key):
    """Device time of one call of a kernel's wrapper: the time of the
    kernels whose name holds ``key``, summed by torch.profiler over
    ``reps`` calls, over ``reps``. Unlike CUDA events around the calls,
    it leaves out the gaps while the host prepares each launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _device_events(prof.key_averages())
               if key in e.key) / 1e3 / reps


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _k1_weights(rng, d, heads, dim_head, hidden, project_out, device):
    inner = heads * dim_head

    def w(out_dim, in_dim):
        return torch.from_numpy((rng.randn(out_dim, in_dim) / np.sqrt(in_dim))
                                .astype(np.float32)).to(device)

    def vec(n, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.randn(n)).astype(np.float32)).to(device)

    p = {}
    for i in ("1", "2"):
        p["ln" + i + "_scale"], p["ln" + i + "_bias"] = vec(d, 1.0), vec(d)
        p["w_qkv" + i] = w(3 * inner, d)
        p["w_out" + i] = w(d, inner) if project_out else None
        p["b_out" + i] = vec(d) if project_out else None
    p["ff_w1"], p["ff_b1"] = w(hidden, d), vec(hidden)
    p["ff_w2"], p["ff_b2"] = w(d, hidden), vec(d)
    return p


def k1_flops(t, s, d, heads, dim_head, hidden, project_out):
    """float32 operations of one block on one sample: the products
    (2 per multiply-add), plus LayerNorm (~8 per element), softmax (~5
    per score) and GELU (~10 per hidden unit)."""
    n, inner = t * s, heads * dim_head
    ops = 0
    for L in (s, t):
        ops += 2 * n * d * 3 * inner + 4 * n * L * inner + 5 * n * L * heads
        ops += 8 * n * d + (2 * n * inner * d if project_out else 0)
    return ops + 4 * n * d * hidden + 10 * n * hidden


def check_k1(rng, device):
    """K1 against its plain version; returns the table entry."""
    shapes = [("mltag", 4096, 6, 4, 10, 2, 10), ("mltag_b4093", 4093, 6, 4, 10, 2, 10),
              ("kkbox", 4096, 6, 14, 40, 8, 10), ("tmall", 4096, 6, 9, 10, 32, 10),
              ("heads1_dh_eq_d", 4096, 6, 4, 10, 1, 10),
              ("heads1_dh_eq_d40", 4096, 6, 14, 40, 1, 40),
              ("d16_dh8", 4093, 6, 4, 16, 2, 8)]
    worst = 0.0
    timed = None
    ms_by_shape, bounds = {}, {}
    for name, B, t, s, d, heads, dim_head in shapes:
        project_out = not (heads == 1 and dim_head == d)
        hidden = 4 * d
        p = _k1_weights(rng, d, heads, dim_head, hidden, project_out, device)
        x = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32)).to(device)
        got = k1.cross_intra_block(x, p, heads, dim_head, project_out)
        want = k1.cross_intra_block_reference(x, p, heads, dim_head, project_out)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= 1e-5 + 1e-4 * want.abs()).all())
        if ok:
            ms_by_shape[name] = _kernel_ms(
                lambda: k1.cross_intra_block(x, p, heads, dim_head, project_out), 20,
                "cross_intra_block")
            bounds[name] = _bound(
                B * k1_flops(t, s, d, heads, dim_head, hidden, project_out),
                2 * B * t * s * d * 4 + sum(w.numel() * 4 for w in p.values()
                                            if w is not None))
        print("K1 {:16s} B={:5d} t={} s={:2d} d={:2d} h={:2d} dh={:2d}: max_abs_err "
              "{:.3e} (rtol 1e-4, atol 1e-5) {}, {:.4f} ms (bound {:.4f} ms)".format(
                  name, B, t, s, d, heads, dim_head, err.max().item(),
                  "ok" if ok else "FAIL", ms_by_shape.get(name, float("nan")),
                  bounds.get(name, (float("nan"),))[0]))
        if not ok:
            raise AssertionError("K1 disagrees with its plain version at " + name)
        worst = max(worst, err.max().item())
        if name == "mltag":
            timed = (x, p, heads, dim_head, project_out)
    x, p, heads, dim_head, project_out = timed

    def call():
        return k1.cross_intra_block(x, p, heads, dim_head, project_out)

    ms = _kernel_ms(call, 50, "cross_intra_block_kernel")
    call_ms = _cuda_ms(call, 50)
    plain_ms = _cuda_ms(lambda: k1.cross_intra_block_reference(
        x, p, heads, dim_head, project_out), 20)
    bound_ms, bound_by = bounds["mltag"]
    return {"name": "cross_intra_block", "route": "cuda",
            "source": "rat_tpu_torch/csrc/cross_intra_block.cu",
            "replaces": "rat_tpu/ops/pallas/cross_intra_block.py:206",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": "B=4096 t=6 s=4 d=10 h=2 dh=10 (ML-Tag block)",
            "call_ms": call_ms, "ms_by_shape": ms_by_shape,
            "bound_ms_by_shape": {name: b[0] for name, b in bounds.items()}}


def _query_idf(db, qry, device):
    """(qry [B, F] int32, its lucene IDF over the pool db [B, F] f32) on
    the device, as the retrieval engine computes them."""
    pack = bm25._pack_idf_dense(bm25._compute_idf_tables(db), device)
    q = torch.from_numpy(np.ascontiguousarray(qry, dtype=np.int32)).to(device)
    return q, bm25._idf_lookup_dense(q, *pack).contiguous()


def _k2_case(db, qry, K, device, pad4=False):
    """Kernel and plain K2 on the same inputs, each finalized. With
    ``pad4`` the pool's columns are padded to a multiple of 4, as
    retrieval/bm25.py pads them (the kernel's 16-byte tile copies);
    without, the kernel takes its 4-byte copies."""
    N, F = db.shape
    cols = max(N, K)
    db_T = torch.zeros((F, cols + (-cols) % 4 if pad4 else cols), dtype=torch.int32,
                       device=device)
    db_T[:, :N] = torch.from_numpy(db.T.astype(np.int32)).to(device)
    q, idf = _query_idf(db, qry, device)
    got = bm25._finalize(*k2.bm25_topk(q, idf, db_T, N, K), False)
    want = bm25._finalize(*k2.bm25_topk_reference(q, idf, db_T, N, K), False)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    return same, (q, idf, db_T, N, K)


def _k2_times(q, idf, db_T, N, K):
    """(kernel ms, call ms, plain ms, bound ms, bound by) of K2 on these
    inputs; the kernel's time is that of its scan and merge on the
    device, the call's that of back-to-back wrapper calls (CUDA events).
    The bound counts one compare and one add per (query, row, field) as
    two operations against the float32 peak, as PERF.md explains."""
    B, F = q.shape
    ms = _kernel_ms(lambda: k2.bm25_topk(q, idf, db_T, N, K), 20, "bm25_")
    call_ms = _cuda_ms(lambda: k2.bm25_topk(q, idf, db_T, N, K), 20)
    plain_ms = _cuda_ms(lambda: k2.bm25_topk_reference(q, idf, db_T, N, K), 2)
    return (ms, call_ms, plain_ms) + _bound(B * N * 2 * F,
                                            F * N * 4 + B * F * 8 + B * K * 8)


def check_k2(rng, device, pool, test):
    """K2 against its plain version, exactly; returns the table entry,
    timed at 4096 queries and at the main path's 5000-query batch."""
    cases = []
    for name, N, Q, F, vocab, K in (("f3_heavy_ties", 20_000, 1000, 3, 6, 5),
                                    ("f11_pool_not_tile_multiple", 50_001, 777, 11, 50, 7),
                                    ("k_above_pool_rows", 7, 300, 3, 4, 10),
                                    ("k32_f5", 9_999, 333, 5, 20, 32)):
        db = rng.randint(0, vocab, (N, F)).astype(np.int64)
        qry = np.concatenate([db[rng.randint(0, N, Q // 2)],
                              rng.randint(0, vocab + 2, (Q - Q // 2, F))])
        cases.append((name, db, qry, K, False))
    used = MLTAG_RETRIEVAL["used_col_indices"]
    batch = MLTAG_RETRIEVAL["qry_batch_size"]
    for B in (4096, batch):
        cases.append(("mltag_b{}_pool".format(B), pool[:, used].astype(np.int64),
                      test[:B, used].astype(np.int64), MLTAG_RETRIEVAL["topK"], True))
    timed = {}
    for name, db, qry, K, pad4 in cases:
        same, args = _k2_case(db, qry, K, device, pad4)
        print("K2 {:28s} N={:8d} B={:5d} F={:2d} K={:2d}: {} (exact)".format(
            name, len(db), len(qry), db.shape[1], K, "equal" if same else "DIFFER"))
        if not same:
            raise AssertionError("K2 disagrees with its plain version at " + name)
        if pad4:
            timed[len(qry)] = args
    N = len(pool)
    ms, call_ms, plain_ms, bound_ms, bound_by = _k2_times(*timed[4096])
    ms_b, call_ms_b, plain_ms_b, bound_ms_b, _ = _k2_times(*timed[batch])
    print("K2 at {} queries: {:.4f} ms (bound {:.4f} ms); at {}: {:.4f} ms (bound "
          "{:.4f} ms)".format(4096, ms, bound_ms, batch, ms_b, bound_ms_b))
    return {"name": "bm25_topk", "route": "cuda",
            "source": "rat_tpu_torch/csrc/bm25_topk.cu",
            "replaces": "rat_tpu/ops/pallas/bm25_scan.py:193",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": "B=4096 F=3 K=5 against the {}-row pool".format(N),
            "call_ms": call_ms, "ms_b{}".format(batch): ms_b,
            "call_ms_b{}".format(batch): call_ms_b,
            "plain_ms_b{}".format(batch): plain_ms_b,
            "bound_ms_b{}".format(batch): bound_ms_b}


def check_k3(rng, device, pool, test):
    """K3 against its plain version, exactly; returns the table entry.
    Its launches are those of its own entry point in the equality
    checks: K3 is on no main path."""
    used = MLTAG_RETRIEVAL["used_col_indices"]
    chunk = MLTAG_RETRIEVAL["db_chunk_size"]
    mltag = pool[:, used].astype(np.int64)
    # (name, pool that gives the IDF, the chunk scored, queries)
    cases = [("mltag_b4096_c50000", mltag, mltag[:chunk],
              test[:4096, used].astype(np.int64))]
    for name, B, C, F, vocab in (("f11_b777_c50001", 777, 50_001, 11, 50),
                                 ("f3_heavy_ties", 1000, 20_000, 3, 6),
                                 ("f16_b333_c9999", 333, 9_999, 16, 20)):
        db = rng.randint(0, vocab, (C, F)).astype(np.int64)
        qry = np.concatenate([db[rng.randint(0, C, B // 2)],
                              rng.randint(0, vocab + 2, (B - B // 2, F))])
        cases.append((name, db, db, qry))
    k3.launches = 0
    timed = None
    for name, idf_pool, db, qry in cases:
        q, idf = _query_idf(idf_pool, qry, device)
        dbc = torch.from_numpy(np.ascontiguousarray(db, dtype=np.int32)).to(device)
        got = k3.bm25_score_chunk(q, idf, dbc)
        want = k3.bm25_score_chunk_reference(q, idf, dbc)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print("K3 {:20s} B={:5d} C={:6d} F={:2d}: {} (torch.equal)".format(
            name, len(qry), len(db), db.shape[1], "equal" if same else "DIFFER"))
        if not same:
            raise AssertionError("K3 disagrees with its plain version at " + name)
        del got, want
        if timed is None:
            timed = (q, idf, dbc)
    launches = k3.launches
    q, idf, dbc = timed
    ms = _kernel_ms(lambda: k3.bm25_score_chunk(q, idf, dbc), 20, "bm25_score_chunk")
    call_ms = _cuda_ms(lambda: k3.bm25_score_chunk(q, idf, dbc), 20)
    plain_ms = _cuda_ms(lambda: k3.bm25_score_chunk_reference(q, idf, dbc), 3)
    B, F = q.shape
    C = dbc.shape[0]
    bound_ms, bound_by = _bound(B * C * 2 * F, B * C * 4 + C * F * 4 + B * F * 8)
    return {"name": "bm25_score_chunk", "route": "cuda",
            "source": "rat_tpu_torch/csrc/bm25_score_chunk.cu",
            "replaces": "rat_tpu/ops/pallas/bm25_scan.py:60",
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "shape": "B=4096 F=3 against the first {} pool rows".format(C),
            "call_ms": call_ms}


def check_k1_grad(rng, device):
    """K1 under autograd: the Function's dx and weight gradients against
    autograd of the plain version, for one random cotangent. Returns the
    forward+backward times (ms) of both at the ML-Tag shape."""
    shapes = [("mltag", 4096, 6, 4, 10, 2, 10), ("mltag_b4093", 4093, 6, 4, 10, 2, 10),
              ("kkbox", 4096, 6, 14, 40, 8, 10), ("heads1_dh_eq_d", 4096, 6, 4, 10, 1, 10),
              ("heads1_dh_eq_d40", 1024, 6, 14, 40, 1, 40)]
    timed = None
    for name, B, t, s, d, heads, dim_head in shapes:
        project_out = not (heads == 1 and dim_head == d)
        p = _k1_weights(rng, d, heads, dim_head, 4 * d, project_out, device)
        names = [n for n in k1.PARAM_ORDER if p[n] is not None]
        x = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32)).to(device)
        g = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32)).to(device)
        inputs = [x.requires_grad_()] + [p[n].requires_grad_() for n in names]

        def fwd_bwd(fn, inputs=inputs, p=p, heads=heads, dim_head=dim_head,
                    project_out=project_out, g=g):
            return torch.autograd.grad(fn(inputs[0], p, heads, dim_head, project_out),
                                       inputs, g)

        got = fwd_bwd(k1.cross_intra_block)
        want = fwd_bwd(k1.cross_intra_block_reference)
        torch.cuda.synchronize()
        worst, worst_name, ok = 0.0, "", True
        for n, a, b in zip(["x"] + names, got, want):
            err = (a - b).abs()
            ok = ok and bool((err <= 1e-4 + 2e-3 * b.abs()).all())
            if err.max().item() >= worst:
                worst, worst_name = err.max().item(), n
        print("K1 grad {:14s} B={:5d} t={} s={:2d} d={:2d} h={} dh={:2d}: dx and {} "
              "weight grads, max_abs_err {:.3e} (at {}) (rtol 2e-3, atol 1e-4) {}".format(
                  name, B, t, s, d, heads, dim_head, len(names), worst, worst_name,
                  "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("K1's gradients disagree with the plain "
                                 "version's at " + name)
        if name == "mltag":
            timed = fwd_bwd
    return {"fwd_bwd_ms": _cuda_ms(lambda: timed(k1.cross_intra_block), 20),
            "plain_fwd_bwd_ms": _cuda_ms(lambda: timed(k1.cross_intra_block_reference), 20)}


def _grads(trainer, data, idx, valid):
    """Loss and {name: gradient} of one train step, without an optimizer
    step."""
    loss = trainer.loss_and_grads(data, idx, valid)
    grads = {n: torch.zeros_like(w, device="cpu") if w.grad is None
             else w.grad.detach().cpu()
             for n, w in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    return loss.item(), grads


def _compare_steps(label, names, a, b):
    """Two (loss, gradients) of one step: losses within 1e-5, every
    gradient within rtol 2e-3 / atol 1e-4 (float32 sums in another
    order; on a GPU the embedding gradients also accumulate with
    atomics). Prints one line; returns the worst errors."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    loss_err = abs(loss_a - loss_b)
    worst, worst_name, ok = 0.0, "", loss_err <= 1e-5
    for n in grads_a:
        err = (grads_a[n] - grads_b[n]).abs()
        if not bool((err <= 1e-4 + 2e-3 * grads_b[n].abs()).all()):
            ok = False
            print("{}: gradient of {} differs by {:.3e}".format(label, n, err.max().item()))
        if err.max().item() >= worst:
            worst, worst_name = err.max().item(), n
    print("{}: {} loss {:.8f}, {} loss {:.8f}, |diff| {:.3e} (tol 1e-5); worst gradient "
          "error {:.3e} at {} (rtol 2e-3, atol 1e-4) {}".format(
              label, names[0], loss_a, names[1], loss_b, loss_err, worst, worst_name,
              "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("{}: the {} step disagrees with the {} step".format(
            label, *names))
    return {"loss_abs_err": loss_err, "grad_max_abs_err": worst}


def one_step_check(trainer, data, batch_size):
    """The fused train step against the module path from the same weights
    and batch (tolerances as :func:`_compare_steps`)."""
    idx = torch.arange(batch_size, device=trainer.device)
    steps = []
    for use_pallas in (True, False):
        trainer.params = dict(trainer.params, use_pallas=use_pallas)
        steps.append(_grads(trainer, data, idx, batch_size))
    trainer.params = dict(trainer.params, use_pallas=True)
    return _compare_steps("one-step", ("fused", "module"), *steps)


def cpu_step_check(trainer, gen, batch_size, label):
    """One train step on the trainer's device against the same step, from
    the same weights and batch, on the CPU (a reference run, named as
    such; tolerances as :func:`_compare_steps`)."""
    cpu = Trainer(trainer.feature_map, trainer.params, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    idx = np.arange(batch_size)
    card = _grads(trainer, trainer.device_split(gen),
                  torch.from_numpy(idx).to(trainer.device), batch_size)
    ref = _grads(cpu, cpu.device_split(gen), torch.from_numpy(idx), batch_size)
    return _compare_steps(label, (trainer.device.type, "CPU reference"), card, ref)


def _k2_batches(n_queries, retrieval):
    return -(-n_queries // retrieval["qry_batch_size"])


def train(device, seed, pool, test, batch_size, model_root):
    """The training path as a user drives it: the pool rows as the train
    split with X-fold self-retrieval, the request rows as the valid split
    retrieved against it, a one-step check, Trainer.fit for one epoch,
    then the best checkpoint reloaded and evaluated. Launch counts are
    zeroed just before and read just after the generators (K2) and the
    fit (K1). Returns (trainer, train generator, dict of results)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fm = mltag_feature_map()
    common = dict(batch_size=batch_size, feature_map=fm, retrieval_augmented=True,
                  device=device)
    k2.launches = 0
    sync()
    t0 = time.perf_counter()
    train_gen = DataGenerator(data_array=pool, shuffle=True,
                              retrieval_configs=dict(MLTAG_RETRIEVAL),
                              retrieval_pool_fname="self", **common)
    sync()
    t1 = time.perf_counter()
    valid_gen = DataGenerator(data_array=test, pool_array=pool,
                              retrieval_configs=dict(MLTAG_RETRIEVAL),
                              retrieval_pool_fname="mltag_train", **common)
    sync()
    t2 = time.perf_counter()
    k2_launches = k2.launches

    params = dict(MLTAG_PARAMS, batch_size=batch_size, seed=seed,
                  model_root=model_root)
    trainer = Trainer(fm, params, device=device)
    one_step = one_step_check(trainer, trainer.device_split(train_gen), batch_size)

    k1.launches = 0
    sync()
    t3 = time.perf_counter()
    trainer.fit(train_gen, valid_gen, epochs=1)
    sync()
    t4 = time.perf_counter()
    k1_launches = k1.launches

    losses = np.asarray(trainer.step_losses)
    if len(losses) != len(train_gen) or not np.all(np.isfinite(losses)):
        raise AssertionError("train: {} step losses for {} batches, finite: {}".format(
            len(losses), len(train_gen), bool(np.all(np.isfinite(losses)))))
    n = min(20, len(losses) // 2)
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    if not last < first:
        raise AssertionError("train: the loss did not fall ({:.6f} over the first "
                             "{} steps, {:.6f} over the last)".format(first, n, last))
    best = trainer._best_metric
    trainer.load_weights(trainer.checkpoint)
    logs = trainer.evaluate(valid_gen)
    if abs(logs["AUC"] - best) > 1e-6:
        raise AssertionError("train: the reloaded best weights give AUC {} against "
                             "the monitored {}".format(logs["AUC"], best))

    retrieval = MLTAG_RETRIEVAL
    folds = int(retrieval["split_type"].split("-")[0])
    fold_size = -(-len(pool) // folds)
    fold_rows = [len(pool[i * fold_size:(i + 1) * fold_size]) for i in range(folds)]
    depth = trainer.model.depth
    expected = {"cross_intra_block": depth * (len(train_gen) + len(valid_gen)),
                "bm25_topk": sum(_k2_batches(r, retrieval) for r in fold_rows)
                + _k2_batches(len(test), retrieval)} if cuda \
        else {"cross_intra_block": 0, "bm25_topk": 0}
    launches = {"cross_intra_block": k1_launches, "bm25_topk": k2_launches}
    if launches != expected:
        raise AssertionError("train: launches {} against the expected {}".format(
            launches, expected))
    return trainer, train_gen, dict(
        {"train_rows": len(pool), "valid_rows": len(test), "steps": len(losses),
         "valid_batches": len(valid_gen), "depth": depth,
         "fold_retrieval_ms": (t1 - t0) * 1e3, "valid_retrieval_ms": (t2 - t1) * 1e3,
         "epoch_s": t4 - t3,
         "epoch_examples_per_s": len(pool) / (t4 - t3),
         "first_steps_loss": first, "last_steps_loss": last,
         "best_AUC": best, "AUC": logs["AUC"], "logloss": logs["logloss"]},
        one_step=one_step, launches=launches)


def _train_batches(trainer, train_gen, seed, n):
    order = train_gen.epoch_index_batches(rng=np.random.RandomState(seed))
    return [(torch.from_numpy(i).to(trainer.device), v)
            for (i, v), _ in zip(order, range(n))]


def steady_ms_per_step(trainer, train_gen, seed, steps=20, batches=None):
    """Host-clock ms per train step over ``steps`` steps after two
    warm-up steps, ending in a synchronize."""
    data = trainer._train_data
    batches = batches or _train_batches(trainer, train_gen, seed, steps + 2)
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
    for idx, valid in batches[:2]:
        trainer.train_step(data, idx, valid)
    sync()
    t0 = time.perf_counter()
    for idx, valid in batches[2:steps + 2]:
        trainer.train_step(data, idx, valid)
    sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile_train(trainer, train_gen, seed, steps=20, rows=15, label="train"):
    """Steady-state ms per train step over ``steps`` steps (host clock
    around a synchronize), then the same number of steps under
    torch.profiler: device time by kernel, K1's forward kernel against
    the autograd backward of the blocks, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    data = trainer._train_data
    batches = _train_batches(trainer, train_gen, seed, 2 * steps + 2)
    ms_per_step = steady_ms_per_step(trainer, train_gen, seed, steps, batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for idx, valid in batches[steps + 2:]:
            trainer.train_step(data, idx, valid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trainer.model.eval()
    events = prof.key_averages()
    kernels = _device_events(events)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_fwd_ms = sum(e.self_device_time_total for e in kernels
                    if "cross_intra_block_kernel" in e.key) / 1e3
    k1_bwd_ms = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.key.startswith("autograd::engine::evaluate_function")
                    and "CrossIntraBlockBackward" in e.key) / 1e3
    print("{} profile: {} steps, wall {:.3f} ms, device busy {:.3f} ms, idle share "
          "{:.4f} (host slowed by the profiler; device {:.3f} ms per step against "
          "{:.3f} ms of wall per step without it)".format(
              label, steps, wall_ms, busy_ms, 1 - busy_ms / wall_ms, busy_ms / steps,
              ms_per_step))
    if k1_fwd_ms:
        print("{} profile: K1 forward kernel {:.3f} ms, block backward (autograd of the "
              "plain block, recomputed) {:.3f} ms of device time".format(
                  label, k1_fwd_ms, k1_bwd_ms))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]:
        print("{} profile: {:10.3f} ms {:6d} calls  {}".format(
            label, e.self_device_time_total / 1e3, e.count, e.key[:100]))
    return {"ms_per_step": ms_per_step,
            "steady_examples_per_s": train_gen.batch_size / ms_per_step * 1e3,
            "profile_wall_ms": wall_ms, "profile_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "device_ms_per_step": busy_ms / steps,
            "device_ops_per_step": sum(e.count for e in kernels) / steps,
            "k1_forward_device_ms": k1_fwd_ms, "block_backward_device_ms": k1_bwd_ms}


def kkbox_feature_map(vocab=None):
    """The KKBox feature map: 11 categorical and 2 sequence fields."""
    fm = FeatureMap("kkbox_x1_10fold_retrieval", ".")
    for name, size in (vocab or KKBOX_VOCAB).items():
        fm.feature_specs[name] = {"source": "", "type": "categorical", "vocab_size": size}
        if name in KKBOX_SEQUENCES:
            fm.feature_specs[name].update(type="sequence", max_len=3,
                                          encoder="MaskedSumPooling")
    fm.set_feature_index()
    fm.num_fields = len(fm.feature_specs)
    fm.num_features = sum(spec["vocab_size"] for spec in fm.feature_specs.values())
    return fm


def kkbox_retrieval(fm):
    return dict(KKBOX_RETRIEVAL, used_col_indices=[
        fm.feature_specs[c]["index"] for c in KKBOX_RETRIEVAL["used_cols"]])


def kkbox_arrays(seed, n_train, n_valid, vocab=None, zipf_a=1.05):
    """(train, valid) float64 rows of the KKBox map's 17 id columns and a
    0/1 label. Ids follow a Zipf law over each vocabulary (id 0 is left
    for the out-of-vocabulary slot); a sequence holds 1 to 3 ids and is
    padded with vocab - 1. Labels come from latent per-id propensities,
    about half positive."""
    rng = np.random.RandomState(seed)
    fm = kkbox_feature_map(vocab)
    n = n_train + n_valid
    cols, logit = [], np.zeros(n)
    for name, spec in fm.feature_specs.items():
        size = spec["vocab_size"]
        real = size - 1 if spec["type"] == "sequence" else size
        p = 1.0 / np.arange(1, real) ** zipf_a
        effect = rng.normal(0, 0.6, size)
        effect[real:] = 0.0
        width = spec.get("max_len", 1)
        ids = 1 + rng.choice(real - 1, (n, width), p=p / p.sum())
        if spec["type"] == "sequence":
            ids[np.arange(width)[None, :] >= rng.randint(1, width + 1, (n, 1))] = size - 1
        cols.append(ids)
        logit += effect[ids].sum(axis=1)
    label = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))
    rows = np.concatenate(cols + [label[:, None]], axis=1).astype(np.float64)
    return rows[:n_train], rows[n_train:]


def _bn_buffers(model):
    return {n: b.detach().clone() for n, b in model.named_buffers() if "running_" in n}


def kkbox_train(device, seed, train, valid, batch_size, model_root, vocab=None):
    """RAT_m2 at KKBox width trained as a user drives it: the train rows
    with 10-fold self-retrieval over the 11 retrieval fields (K2 at
    F=11), the valid rows retrieved against them, Trainer.fit for one
    epoch on the module path, the best checkpoint reloaded. Checks: no
    K1 launch (the gate), K2's launch count, finite losses, BatchNorm's
    running statistics moved, the reload gives the monitored AUC, AUC
    above 0.5, the neighbours of 512 valid queries equal the plain
    scan's, and the card's eval-mode logits of 512 valid rows within
    1e-5 of the same weights run on the CPU (a reference run). Returns
    (trainer, train generator, dict of results)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fm = kkbox_feature_map(vocab)
    retrieval = kkbox_retrieval(fm)
    common = dict(batch_size=batch_size, feature_map=fm, retrieval_augmented=True,
                  device=device)
    k2.launches = 0
    sync()
    t0 = time.perf_counter()
    train_gen = DataGenerator(data_array=train, shuffle=True,
                              retrieval_configs=dict(retrieval),
                              retrieval_pool_fname="self", **common)
    sync()
    t1 = time.perf_counter()
    valid_gen = DataGenerator(data_array=valid, pool_array=train,
                              retrieval_configs=dict(retrieval),
                              retrieval_pool_fname="kkbox_train", **common)
    sync()
    t2 = time.perf_counter()
    k2_launches = k2.launches
    n_chk = check_neighbours(valid_gen, train, valid, retrieval, device, "kkbox_train")
    k2_f11 = {}
    if cuda:
        # K2 at the valid split's batch (2400 queries against the train
        # rows, F=11), equal to its plain version, then timed; these
        # launches are not the path's
        used, batch = retrieval["used_col_indices"], retrieval["qry_batch_size"]
        same, args = _k2_case(train[:, used].astype(np.int64),
                              valid[:batch, used].astype(np.int64), retrieval["topK"],
                              device, pad4=True)
        if not same:
            raise AssertionError("kkbox_train: K2 at F=11 disagrees with its plain version")
        k2_f11 = dict(zip(("ms", "call_ms", "plain_ms", "bound_ms", "bound_by"),
                          _k2_times(*args)))
        print("K2 kkbox_b{}_pool N={} F=11 K={}: equal (exact), {:.4f} ms (bound {:.4f} "
              "ms)".format(batch, len(train), retrieval["topK"], k2_f11["ms"],
                           k2_f11["bound_ms"]))

    params = dict(KKBOX_PARAMS, batch_size=batch_size, seed=seed, model_root=model_root)
    trainer = Trainer(fm, params, device=device)
    if trainer._use_fast_forward():
        raise AssertionError("kkbox_train: the gate let a BatchNorm and dropout model "
                             "onto the fused path")
    bn_before = _bn_buffers(trainer.model)
    k1.launches = 0
    sync()
    t3 = time.perf_counter()
    trainer.fit(train_gen, valid_gen, epochs=1)
    sync()
    t4 = time.perf_counter()
    k1_launches = k1.launches

    losses = np.asarray(trainer.step_losses)
    if len(losses) != len(train_gen) or not np.all(np.isfinite(losses)):
        raise AssertionError("kkbox_train: {} step losses for {} batches, finite: {}"
                             .format(len(losses), len(train_gen),
                                     bool(np.all(np.isfinite(losses)))))
    bn_after = _bn_buffers(trainer.model)
    if not bn_before or any(torch.equal(bn_before[n], bn_after[n]) for n in bn_before):
        raise AssertionError("kkbox_train: BatchNorm's running statistics did not move")
    best = trainer._best_metric
    trainer.load_weights(trainer.checkpoint)
    logs = trainer.evaluate(valid_gen, data=trainer._valid_data)
    if abs(logs["AUC"] - best) > 1e-6 or not logs["AUC"] > 0.5:
        raise AssertionError("kkbox_train: the reloaded best weights give AUC {} against "
                             "the monitored {} (must be above 0.5)".format(logs["AUC"], best))

    # the card's eval-mode logits against the same weights on the CPU
    idx = torch.arange(min(512, len(valid)), device=trainer.device)
    X, y, Xf, _ = _gather_batch(trainer._valid_data, idx)
    cpu_model = build_model(fm, params)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    with torch.no_grad():
        got = trainer.model(X, y, Xf)["y_pred"].cpu()
        want = cpu_model.eval()(X.cpu(), y.cpu(),
                                None if Xf is None else Xf.cpu())["y_pred"]
    logits_err = float((got - want).abs().max())
    if logits_err > 1e-5:
        raise AssertionError("kkbox_train: the card's logits differ from the CPU "
                             "reference run's by {}".format(logits_err))

    folds = int(retrieval["split_type"].split("-")[0])
    fold_size = -(-len(train) // folds)
    fold_rows = [len(train[i * fold_size:(i + 1) * fold_size]) for i in range(folds)]
    expected = {"cross_intra_block": 0,
                "bm25_topk": sum(_k2_batches(r, retrieval) for r in fold_rows)
                + _k2_batches(len(valid), retrieval) if cuda else 0}
    launches = {"cross_intra_block": k1_launches, "bm25_topk": k2_launches}
    if launches != expected:
        raise AssertionError("kkbox_train: launches {} against the expected {}".format(
            launches, expected))
    return trainer, train_gen, dict(
        {"train_rows": len(train), "valid_rows": len(valid),
         "rows_cut_from": "5,901,932 train / 737,743 valid (BASELINE.md), for chip time",
         "fields": fm.num_fields, "retrieval_fields": len(retrieval["used_cols"]),
         "parameters": sum(p.numel() for p in trainer.model.parameters()),
         "steps": len(losses), "valid_batches": len(valid_gen),
         "fold_retrieval_ms": (t1 - t0) * 1e3, "valid_retrieval_ms": (t2 - t1) * 1e3,
         "epoch_s": t4 - t3, "epoch_examples_per_s": len(train) / (t4 - t3),
         "first_step_loss": float(losses[0]), "last_step_loss": float(losses[-1]),
         "best_AUC": best, "AUC": logs["AUC"], "logloss": logs["logloss"],
         "neighbours_checked": n_chk, "card_vs_cpu_logits_max_abs_err": logits_err},
        k2_f11=k2_f11, launches=launches)


def step_split(trainer, train_gen, seed, reps=5):
    """Device time (torch.profiler, ms per call) of one train batch's
    parts, each forward and backward on its own: the embedding gathers
    and their backward, the encoder (forward alone, then with its
    backward), and the DNN with its BatchNorm; BatchNorm's running
    statistics are put back afterwards."""
    model = trainer.model
    saved = _bn_buffers(model)
    model.train()
    idx, _ = _train_batches(trainer, train_gen, seed, 1)[0]
    X, y, Xf, _ = _gather_batch(trainer._train_data, idx)
    with torch.no_grad():
        feature_emb, grid = model.grid(X, y, Xf)
    target = feature_emb[:, 0].reshape(len(X), -1)

    def backward(out):
        out.backward(torch.ones_like(out))

    def embedding():
        backward(model.grid(X, y, Xf)[1])

    def encoder_fwd():
        with torch.no_grad():
            model.encoder(model.emb_drop(grid))

    def encoder():
        backward(model.encoder(model.emb_drop(grid.requires_grad_())))

    def dnn():
        backward(model.dnn(target.requires_grad_()))

    split = {name: _kernel_ms(fn, reps, "") for name, fn in (
        ("embedding_fwd_bwd", embedding), ("encoder_fwd", encoder_fwd),
        ("encoder_fwd_bwd", encoder), ("dnn_bn_fwd_bwd", dnn))}
    trainer.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n in saved:
                b.copy_(saved[n])
    model.eval()
    return split


# RAT_m0, RAT_m1 and RAT_m3 at the widths and settings of their ML-Tag
# configs (configs/RAT_m{0,1,3}/movielenslatest_x1/model_config.yaml):
# the ML-Tag RAT_m2 settings, without the fused path switch
VARIANT_PARAMS = {
    name: dict({k: v for k, v in MLTAG_PARAMS.items() if k != "use_pallas"},
               model=name, model_id=name + "_movielenslatest_x1_10fold_retrieval")
    for name in ("RAT_m0", "RAT_m1", "RAT_m3")}


def variants(device, seed, train_gen, valid_gen, batch_size, model_root):
    """RAT_m0, RAT_m1 and RAT_m3 on the train phase's generators (their
    neighbours already retrieved): for each, one train step on the device
    against the same step on the CPU, Trainer.fit for one epoch, the best
    checkpoint reloaded, and the steady ms per step (on a GPU with a
    short profile: device time per step, idle share). No kernel is
    launched in the fits (asserted). Returns {variant: results}."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for name, base in VARIANT_PARAMS.items():
        params = dict(base, batch_size=batch_size, seed=seed,
                      model_root=os.path.join(model_root, name))
        trainer = Trainer(train_gen.feature_map, params, device=device)
        one_step = cpu_step_check(trainer, train_gen, batch_size,
                                  "variants {} one-step".format(name))
        k1.launches = k2.launches = 0
        sync()
        t0 = time.perf_counter()
        trainer.fit(train_gen, valid_gen, epochs=1)
        sync()
        epoch_s = time.perf_counter() - t0
        launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches}
        if launches != {"cross_intra_block": 0, "bm25_topk": 0}:
            raise AssertionError("variants {}: launches {} in its fit".format(name, launches))
        losses = np.asarray(trainer.step_losses)
        if len(losses) != len(train_gen) or not np.all(np.isfinite(losses)):
            raise AssertionError("variants {}: bad step losses".format(name))
        best = trainer._best_metric
        trainer.load_weights(trainer.checkpoint)
        logs = trainer.evaluate(valid_gen, data=trainer._valid_data)
        if abs(logs["AUC"] - best) > 1e-6:
            raise AssertionError("variants {}: the reloaded best weights give AUC {} "
                                 "against the monitored {}".format(name, logs["AUC"], best))
        timing = profile_train(trainer, train_gen, seed, steps=10, rows=5,
                               label="variants " + name) if cuda \
            else {"ms_per_step": steady_ms_per_step(trainer, train_gen, seed)}
        out[name] = dict({"steps": len(losses), "epoch_s": epoch_s,
                          "AUC": logs["AUC"], "logloss": logs["logloss"],
                          "one_step": one_step, "launches": launches},
                         **{k: timing[k] for k in ("ms_per_step", "device_ms_per_step",
                                                   "idle_share") if k in timing})
        print("variants {}: {}".format(name, json.dumps(out[name])))
        del trainer
    return out


def _ptxas_report(name):
    """{kernel (mangled): (registers, bytes of spill stores)} from
    ptxas's report of csrc/<name>.cu."""
    with open(os.path.join(_build.BUILD_DIR, name + ".log")) as fh:
        text = fh.read()
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        fn = m.group(1) if m else fn
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn] = (out.get(fn, (0, 0))[0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), out.get(fn, (0, 0))[1])
    return out


def _print_build_report(device):
    """ptxas's register and spill report, summed up per source, then the
    registers and CTAs per SM of the main path's K1 and K2 kernels.
    Fails if any kernel of K1 or K2 spills."""
    spilled = []
    for name in sorted(f[:-4] for f in os.listdir(_build.BUILD_DIR) if f.endswith(".log")):
        report = _ptxas_report(name)
        regs = max((r for r, _ in report.values()), default=0)
        spills = max((sp for _, sp in report.values()), default=0)
        print("ptxas {}: {} kernels, at most {} registers and {} bytes of spill stores "
              "per thread".format(name, len(report), regs, spills))
        if name in ("bm25_topk", "cross_intra_block"):
            spilled += [fn for fn, (_, sp) in report.items() if sp > 0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k2_report, k1_report = _ptxas_report("bm25_topk"), _ptxas_report("cross_intra_block")

    def regs(report, pattern):
        return [r for fn, (r, _) in report.items() if pattern in fn]

    qpc, slots = k2._occupancy(3, MLTAG_RETRIEVAL["topK"], device.index)
    print("K2 main path (F=3, K=5): scan {} registers, {} CTAs of {} queries per SM; "
          "merge {} registers".format(regs(k2_report, "bm25_scan_kernelILi3EE"),
                                      slots // sms, qpc,
                                      regs(k2_report, "bm25_merge_kernel")))
    warps, staged, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fn = _build.load("cross_intra_block").cross_intra_block_occupancy
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    d, heads, dh = (MLTAG_PARAMS[k] for k in ("embedding_dim", "num_heads", "dim_head"))
    _build.check(fn(1 + MLTAG_RETRIEVAL["topK"], len(MLTAG_VOCAB) + 1, d, heads, dh,
                    MLTAG_PARAMS["scale_dim"] * d, 1, ctypes.byref(warps),
                    ctypes.byref(staged), ctypes.byref(per_sm)), "K1 occupancy")
    print("K1 main path (d=10, dh=10): {} registers, {} CTAs of {} warps per SM, "
          "weights {}".format(regs(k1_report, "cross_intra_block_kernelILi10ELi10ELb{}E".format(
                                  staged.value)),
                              per_sm.value, warps.value,
                              "in shared memory" if staged.value else "read from L1/L2"))
    if spilled:
        raise AssertionError("ptxas: K1/K2 kernels spill registers: {}".format(spilled))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    device = torch.device("cuda", 0)
    print("torch {} cuda {} python {}".format(torch.__version__, torch.version.cuda,
                                              sys.version.split()[0]))

    t0 = time.perf_counter()
    _build.build_all()
    print("build: {:.1f} s".format(time.perf_counter() - t0))
    _print_build_report(device)

    rng = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    pool, test = mltag_arrays(args.seed, MLTAG_POOL_ROWS, MLTAG_TEST_ROWS)
    print("data: {} pool rows, {} requests in {:.1f} s".format(
        len(pool), len(test), time.perf_counter() - t0))
    kernels = [check_k1(rng, device), check_k2(rng, device, pool, test),
               check_k3(rng, device, pool, test)]
    kernels[0].update(check_k1_grad(rng, device))
    k3_checks = k3.launches      # K3 is on no path: none may follow

    batch_size = MLTAG_PARAMS["batch_size"]
    res = serve(device, args.seed, pool, test, batch_size)
    serve_launches = res.pop("launches")
    print("serve: " + json.dumps(res))
    print("serve launches: " + json.dumps(serve_launches))
    if serve_launches["bm25_topk"] < 1:
        raise AssertionError("serve: K2 was never launched")
    if serve_launches["cross_intra_block"] != res["depth"] * res["batches"]:
        raise AssertionError("serve: K1 launched {} times, expected depth x "
                             "batches = {}".format(serve_launches["cross_intra_block"],
                                                   res["depth"] * res["batches"]))
    profile_serve(device, args.seed, pool, test, batch_size)

    with tempfile.TemporaryDirectory() as model_root:
        trainer, train_gen, res = train(device, args.seed, pool, test, batch_size,
                                        model_root)
        train_launches = res.pop("launches")
        print("train: " + json.dumps(res))
        print("train launches (asserted: K1 = depth x (train steps + valid batches), "
              "K2 = query batches of the 10 folds + the valid split): "
              + json.dumps(train_launches))
        print("train steady state: " + json.dumps(
            profile_train(trainer, train_gen, args.seed)))

        kk_train, kk_valid = kkbox_arrays(args.seed, KKBOX_TRAIN_ROWS, KKBOX_VALID_ROWS)
        kk_trainer, kk_gen, res = kkbox_train(device, args.seed, kk_train, kk_valid,
                                              batch_size, os.path.join(model_root, "kkbox"))
        kkbox_launches = res.pop("launches")
        kernels[1].update({k + "_kkbox_f11": v for k, v in res.pop("k2_f11").items()})
        print("kkbox_train: " + json.dumps(res))
        print("kkbox_train launches (asserted: K1 = 0, the gate; K2 = query batches of "
              "the 10 folds + the valid split): " + json.dumps(kkbox_launches))
        steady = profile_train(kk_trainer, kk_gen, args.seed, steps=10,
                               label="kkbox_train")
        steady["step_split_device_ms"] = step_split(kk_trainer, kk_gen, args.seed)
        print("kkbox_train steady state: " + json.dumps(steady))
        del kk_trainer, kk_gen, kk_train, kk_valid
        torch.cuda.empty_cache()

        res = variants(device, args.seed, train_gen, trainer.valid_gen, batch_size,
                       model_root)
        variant_launches = {k: sum(r["launches"][k] for r in res.values())
                            for k in ("cross_intra_block", "bm25_topk")}
    if k3.launches != k3_checks:
        raise AssertionError("K3 was launched on a path")
    by_path = {"serve": serve_launches, "train": train_launches,
               "kkbox_train": kkbox_launches, "variants": variant_launches}
    for entry in kernels:
        counts = {path: launches.get(entry["name"], 0)
                  for path, launches in by_path.items()}
        if entry["name"] in serve_launches:
            entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
