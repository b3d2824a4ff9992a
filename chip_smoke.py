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
3b. emb grad — the embedding lookups' backward (ops.embedding_grad) at
             the train cells' shapes (a batch of 4096 x 6 samples drawn
             as the ML-Tag and KKBox phases draw their rows: the packed
             table, the label table, the wide tower's d = 1 table): the
             kernel against index_put_ and PyTorch's
             embedding_dense_backward (F.embedding's backward) exactly
             (quarter-integer gradients sum exactly), each timed on the
             device (all its kernels per call, torch.profiler) and with
             CUDA events, index_put_ and embedding_dense_backward beside
             it, and the bytes' bound.
3c. attention — the module encoder's attention (ops.attention) at the
             module path's shapes (KKBox's and Tmall's RAT_m2 intra and
             cross, ML-Tag's RAT_m0 joint sequence and RAT_m1's
             Transformers) and edges: the kernel's output and d(qkv)
             against the plain version's within K1's tolerances, a
             second call bit-equal; the device ms of both kernels, the
             plain version's and scaled_dot_product_attention's ms (a
             yardstick the port never calls), and the bounds.
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
             runs, the attention kernel's launches asserted (8 forward
             and 8 backward a train step, 8 forward an eval batch), K2
             at F=11 held to its plain version and timed at the valid
             split's 2400-query batch, then a short profile and the
             step's device-time split.
9. grouped — grouped dispatch against per-step dispatch, on the train
             and kkbox_train phases' trainers and splits (no new
             retrieval): from one saved state (weights, Adam, the dropout
             generator), 2 groups of 64 ML-Tag steps per step twice, then
             grouped with the CUDA graph of the step's forward and
             backward (K1 inside; the optimizer steps after each replay),
             the LR plateau's decay between the groups in each: step
             losses and final weights and buffers within the larger of
             twice the per-step spread and the stated float32 bounds, K1
             = depth x steps under replay; host ms per step in turns, and
             device ms per step and idle share under the profiler, both
             ways; the 200,686 valid rows scored per batch and grouped
             (the eval graph) in turns, predictions within 1e-6,
             examples/s; 8 KKBox steps (BatchNorm, embedding dropout)
             eagerly and as one graphed group from one state, or the
             gate's reason where the graph is closed; the 128 ML-Tag
             steps again with ``dedup_neighbors``, per step and graphed,
             equal bit for bit to each other and to the plain run, and a
             profiled window each way.
10. variants — RAT_m0, RAT_m1 and RAT_m3 at the full widths of their
             ML-Tag configs on the train phase's data and neighbours:
             one step on the card against the same step on the CPU,
             one epoch of Trainer.fit, the reload, steady ms per step
             and a short profile (device time per step, idle share).
11. cli    — the published ML-Tag experiment run as a user runs it,
             ``python -m rat_tpu_torch.cli.run_expid --config ... --expid
             RAT_m2_movielenslatest_x1_10fold_retrieval --gpu 0``, in a
             subprocess, on CSVs of MovielensLatest_x1's split sizes
             (1,404,801 / 401,372 / 200,686 rows, ids over ML-Tag's
             vocabularies) written by the port's make_mltag_like, with a
             copy of configs/RAT_m2/movielenslatest_x1 that changes only
             the paths, ``epochs: 2`` and adds ``use_pallas: true``:
             dataset build from the CSVs, 10-fold retrieval (K2), two
             epochs (K1), reload, valid and test, the results line. The
             launch counts are asserted; a second run must build
             nothing, retrieve nothing (K2 = 0) and give the same
             metrics exactly; the fitted vocabularies must be ML-Tag's
             and the train split's cached neighbours of 512 queries
             equal to the plain scan's.
12. blocks — the same experiment with ``data_block_size: 300000`` and
             one epoch, from the cli phase's CSVs, built into a data
             directory of its own (5 train, 2 valid and 1 test block):
             (a) per-block 10-fold retrieval, valid and test against the
             first train block, block-mode training and evaluation; (b)
             ``inter_block_retrieval: true`` with ``profile_dir`` (the
             valid and test caches of (a) read). Launch counts from the
             block sizes, neighbours of 512 queries in each against plain
             scans, the trainer's peak of split bytes equal to one
             block's, the trace file; stage seconds per block.
13. mesh    — the multi-device layer at the same ML-Tag config, on the
             serve and train arrays: (a) the pool-sharded BM25 scan with
             4 shards run in turn (each K2 on its 400,000-row shard, then
             the merge), equal bit for bit to the unsharded retrieval,
             K2 = 4 x 41; (b) a one-rank NCCL process group and a real
             1x1 mesh: the 10-fold self-retrieval through the sharded
             engine (its cache equal to the unsharded neighbours), the
             first step's loss and gradients against the non-mesh
             Trainer's, one epoch of Trainer.fit with K1 on the local
             batch (grouped, the step graph replayed with its
             collectives captured), the evaluation, the weights and
             full-state round trips; from one state, 2 groups of 64 steps
             per step and graphed, the LR decay between them, equal bit
             for bit (losses, weights, Adam's moments), K1 = depth x
             steps, 127 replays, host ms per step in turns and device ms
             per step and idle share profiled, each way; the valid split
             per batch and graphed, equal bit for bit; 8 steps of a
             BatchNorm trainer on the mesh eagerly and as one graphed
             group (BatchNorm's all-reduces captured), equal bit for bit;
             and per-step ms beside the non-mesh trainer's (the cost of
             the collectives on one rank).
14. exact_match — exact-match retrieval over the serve phase's arrays
             (200,686 requests, 1,404,801 rows, K=5, batches of 5000):
             user_id exact on Zipf ids, user_id exact on uniform ids, all
             three columns exact; each call's first batch equal to the
             same call on the CPU bit for bit, no kernel launched.

15. native — the native host encoder (rat_tpu_torch/native): whether
             the interpreter's Python.h is there, the extension's g++
             build, then a KKBox-shaped dataset (the port's
             make_kkbox_like at KKBox's vocabularies, 500,000 / 50,000 /
             50,000 rows, string ids and a genre sequence as the published
             config reads them) built twice, with the extension and with
             the Python encoders: feature_map.json byte-identical and every
             split equal; each build's seconds by stage. Runs before cli,
             whose Stage seconds now split the build the same way and whose
             encoder for ML-Tag's float ids must be python.
16. bench  — the port's benchmark suite (rat_tpu_torch.cli.benchmark) in
             this process at cut step counts: train on the ML-Tag shape,
             plain and fused, on KKBox's and on Tmall's, eval on ML-Tag,
             BM25 and exact-match retrieval, each bench's kernel launches
             asserted; the BM25 bench's pool and queries retrieved once
             more with every K2 call (2048-query batches and the 1,696-
             query tail, 200,000 rows) held to its plain version exactly;
             then bench_torch.py's headline (fused path, default
             steps, with the card's health stamp, which must have no error,
             no invalid probe and, at the default matmul precision, TF32
             off) and rat_tpu_torch.ops.bench_kernel (K1
             against the plain block) as subprocesses. bench_scaling needs
             two cards and is not run.
17. autotune — a two-expid sweep (learning_rate 1e-3 and 1e-4 on the
             demo experiment with use_pallas) enumerated by
             rat_tpu_torch.autotuner and run by grid_search at once over
             this card and a CPU slot: both exit 0 with a results line, and
             the card run's log counts K1 launches. Before the sweep, K2 at
             its runs' shapes (fold 0, 800 queries x 7,200 rows; valid and
             test, 2,000 x 8,000) through the retrieval engine and K1 at
             B=1024 (whole, and padded as the last train and valid
             batches are) are held to their plain versions.
18. precision — the JAX package's reduced-precision gate
             (tests/test_bf16_gate.py) at its shape and bounds:
             RAT_m2 at d=40, 8 heads x 10, depth 2, BatchNorm, the wide
             tower, on 8,192 / 2,048 rows of its synthetic data (2-fold
             self-retrieval and the valid split through K2, topK 3), 4
             epochs, fitted at float32 and again at bfloat16 (TF32 on this
             card) through rat_tpu_torch.set_matmul_precision, float32
             restored after: |dAUC| < 0.005 and |dlogloss| < 0.01; the
             setting reaches the products (a 1024 x 1024 product's error
             against float64 at least 10x float32's, the fits' predictions
             differ), the switch reads each setting, every K2 call equals
             its plain version, the neighbour caches are identical, K2 =
             2 x 5, K1 = K3 = 0; a health stamp in a process started with
             RAT_TPU_MATMUL_PRECISION=bfloat16 reads TF32 on; the bench's
             Tmall and KKBox train steps' device ms in one window at each
             setting (recorded).
19. nnlib — the NN library off the main path (rat_tpu_torch.nn's
             interaction, target-attention, APG and MLP-block, graph and v2
             feature-embedding layers, FM, the merged embedding and PET's
             graphs) at the KKBox config's widths: 13 fields, d=40, 4096
             groups of 1+K = 6 rows of the KKBox map's 17 id columns, DNN
             400^3. Each layer runs forward and backward on the card and on
             the CPU with the same weights and inputs: outputs within rtol
             1e-4 / atol 1e-5, parameter and input gradients within rtol
             2e-3 / atol 1e-4; ms per forward+backward (CUDA events) and the
             peak of max_memory_allocated; one ``nnlib:`` line per family.
             No kernel is launched (asserted).
20. scripts — the JAX package's run scripts as ported
             (rat_tpu_torch.scripts), each through its main as a user runs
             it: (a) tmall_rehearsal --scale 0.03 on
             configs/RAT_m2/tmall_x1_002 (601,164 train, 634,960 valid and
             600,000 explicit pool rows made from seed 11; the CSVs, the
             build, both splits' retrieval through K2 in batches of 2,500
             queries, one epoch with BatchNorm and dropout, so K1's gate is
             closed, and the evaluations), launches asserted at K2 = 241 +
             254 and K1 = K3 = 0, the first K2 call held to its plain
             version, 512 neighbours of each split against plain scans, K2
             timed at 2,500 x 600,000 with F=5; (b) tmall_rehearsal_tail
             --valid-rows 100000 on (a)'s build under stall_guard, a
             subprocess (exit 0, no kill); (c) profile_train_step at the
             ML-Tag and Tmall bench shapes (top 15 kernels of each); (d)
             degraded_ab; (e) dedup_ab --time (windows of 128 steps,
             each arm's dispatch printed); (f) tax_probe; (g)
             gm_encoder_ab --parity at ML-Tag's and KKBox's widths
             (forward within 1e-4, gradients within 1e-3 relative); (h)
             chip_health. No kernel is launched after (a) (asserted).

The line before the last is the kernel table as JSON; the last line
says the run was ok, and names the device. Without CUDA the script
exits non-zero before printing either.
"""

import argparse
import contextlib
import copy
import ctypes
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist

import rat_tpu_torch
from rat_tpu_torch import autotuner
from rat_tpu_torch import native as native_ext
from rat_tpu_torch.cli import benchmark
from rat_tpu_torch.data.build import build_dataset
from rat_tpu_torch.data.io import load_arrays
from rat_tpu_torch.data.loader import DataGenerator, retrieval_cache_path
from rat_tpu_torch.data.synthetic import make_kkbox_like, make_mltag_like
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_learning_rate
from rat_tpu_torch.engine.trainer import _gather_batch
from rat_tpu_torch.features import FeatureEncoder, FeatureMap, preprocess
from rat_tpu_torch.models import build_model
from rat_tpu_torch.nn.embedding import EmbeddingSpec
from rat_tpu_torch.ops import _build
from rat_tpu_torch.ops import attention as attn
from rat_tpu_torch.ops import bm25_score_chunk as k3
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1
from rat_tpu_torch.ops import embedding_grad as emb_grad
from rat_tpu_torch.parallel import initialize_distributed, make_mesh, process_local_rows
from rat_tpu_torch.parallel.distributed import free_port
from rat_tpu_torch.parallel.dryrun import local_leaves, one_step
from rat_tpu_torch.retrieval import bm25, sharded
from rat_tpu_torch.utils import load_config
from rat_tpu_torch.utils.yaml_subset import dump as yaml_dump
from rat_tpu_torch.utils.yaml_subset import safe_load

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

REPO = os.path.dirname(os.path.abspath(__file__))
# the cli phase: the published ML-Tag experiment run through the port's
# CLI from CSV (configs/RAT_m2/movielenslatest_x1), on CSVs of
# MovielensLatest_x1's split sizes whose ids span ML-Tag's vocabularies
MLTAG_CONFIG = os.path.join(REPO, "configs", "RAT_m2", "movielenslatest_x1")
MLTAG_EXPID = "RAT_m2_movielenslatest_x1_10fold_retrieval"
MLTAG_SPLIT_ROWS = (1_404_801, 401_372, 200_686)
MLTAG_IDS = {"n_users": 16_972, "n_items": 23_744, "n_tags": 49_658}

# RAT_m2_kkbox_x1_10fold_retrieval at its published widths and training
# settings (configs/RAT_m2/kkbox_x1/model_config.yaml), plus the fused
# kernel path switch, which the JAX gate turns off for this config
# (BatchNorm, embedding dropout)
KKBOX_PARAMS = dict(MLTAG_PARAMS, **{
    "model_id": "RAT_m2_kkbox_x1_10fold_retrieval",
    "dataset_id": "kkbox_x1_10fold_retrieval",
    "embedding_dim": 40, "num_heads": 8, "dim_head": 10, "depth": 4, "scale_dim": 2,
    "batch_norm": True, "emb_dropout": 0.1, "embedding_regularizer": 0.0005})
# the lookups whose tables take a gradient in one train step of either
# config (the packed table, the wide tower's, the label table): each
# runs the embedding backward's kernel once on a card
EMB_GRAD_PER_STEP = 3
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
    """Device time of one call of a kernel's wrapper: for each kernel
    whose name holds ``key``, its mean time per launch that
    torch.profiler recorded over ``reps`` calls, times its launches per
    call, summed. Unlike CUDA events around the calls, it leaves out the
    gaps while the host prepares each launch. A total over ``reps``
    reads a launch the profiler did not record as a faster kernel (one
    run put K3 below its bound that way); the mean per recorded launch
    does not."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler has come back with no kernel record at all (one run
    # of seven K1 shapes); a second profile of the same calls is taken
    # before that counts as a failure
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in _device_events(prof.key_averages()) if key in e.key]
        if events:
            break
    else:
        raise AssertionError("no kernel named like {!r} in the profile".format(key))
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
               for e in events) / 1e3


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


def _k1_case(rng, device, B, t, s, d, heads, dim_head, hidden=None, valid=None):
    """K1 and its plain version on one random block input [B, t, s, d]
    with random weights (hidden 4d unless given); with ``valid``, rows
    from ``valid`` on repeat row 0, as a padded last batch does. Returns
    (within rtol 1e-4 / atol 1e-5, |error|, x, weights, project_out)."""
    project_out = not (heads == 1 and dim_head == d)
    p = _k1_weights(rng, d, heads, dim_head, hidden or 4 * d, project_out, device)
    x = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32)).to(device)
    if valid is not None:
        x[valid:] = x[0]
    got = k1.cross_intra_block(x, p, heads, dim_head, project_out)
    want = k1.cross_intra_block_reference(x, p, heads, dim_head, project_out)
    if x.is_cuda:
        torch.cuda.synchronize()
    err = (got - want).abs()
    return bool((err <= 1e-5 + 1e-4 * want.abs()).all()), err, x, p, project_out


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
        ok, err, x, p, project_out = _k1_case(rng, device, B, t, s, d, heads, dim_head)
        hidden = 4 * d
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


@contextlib.contextmanager
def k2_held_to_plain(phase, max_calls=None):
    """Inside, every K2 call of the retrieval engine (the first
    ``max_calls`` of them, when given) also runs K2's plain version on
    the same inputs, and the two must be equal after the zero-score drop
    (values, indices and counts, ties included). Yields {queries in the
    call: calls compared}. These plain runs launch no kernel, and the
    comparison adds no launch to K2's count."""
    kernel = bm25.bm25_topk
    compared = {}

    def both(qry, qry_idf, db_T, db_valid_len, topk):
        v, i = kernel(qry, qry_idf, db_T, db_valid_len, topk)
        if max_calls is not None and sum(compared.values()) >= max_calls:
            return v, i
        want = bm25._finalize(*k2.bm25_topk_reference(qry, qry_idf, db_T, db_valid_len,
                                                      topk), False)
        if not all(torch.equal(a, b) for a, b in zip(bm25._finalize(v, i, False), want)):
            raise AssertionError("{}: K2 differs from its plain version at {} queries x "
                                 "{} rows".format(phase, len(qry), db_valid_len))
        compared[len(qry)] = compared.get(len(qry), 0) + 1
        return v, i

    bm25.bm25_topk = both
    try:
        yield compared
    finally:
        bm25.bm25_topk = kernel


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
    autograd of the plain version, for one random cotangent. Each line
    says whether the backward ran K1's backward kernel or autograd of the
    plain block (the shapes the kernel does not take); the ML-Tag shapes
    must run the kernel. Returns the forward+backward times (ms) of both
    and the backward kernels' device ms at the ML-Tag shape."""
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

        before = (k1.grad_launches, k1.grad_plain)
        got = fwd_bwd(k1.cross_intra_block)
        path = "kernel" if k1.grad_launches == before[0] + 1 else \
            "plain" if k1.grad_plain == before[1] + 1 else "?"
        want = fwd_bwd(k1.cross_intra_block_reference)
        torch.cuda.synchronize()
        worst, worst_name, ok = 0.0, "", True
        for n, a, b in zip(["x"] + names, got, want):
            err = (a - b).abs()
            ok = ok and bool((err <= 1e-4 + 2e-3 * b.abs()).all())
            if err.max().item() >= worst:
                worst, worst_name = err.max().item(), n
        print("K1 grad {:14s} B={:5d} t={} s={:2d} d={:2d} h={} dh={:2d}: dx and {} "
              "weight grads ({} backward), max_abs_err {:.3e} (at {}) (rtol 2e-3, "
              "atol 1e-4) {}".format(name, B, t, s, d, heads, dim_head, len(names), path,
                                     worst, worst_name, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("K1's gradients disagree with the plain "
                                 "version's at " + name)
        if name.startswith("mltag") and path != "kernel":
            raise AssertionError("K1's backward kernel did not run at " + name)
        if name == "mltag":
            timed = fwd_bwd
    return {"fwd_bwd_ms": _cuda_ms(lambda: timed(k1.cross_intra_block), 20),
            "plain_fwd_bwd_ms": _cuda_ms(lambda: timed(k1.cross_intra_block_reference), 20),
            "grad_kernel_ms": _kernel_ms(lambda: timed(k1.cross_intra_block), 20, "k1_grad")}


# (name, sequences, tokens, heads, dim_head) of the attention kernel's
# cases: the module path's shapes at a batch of 4096 (KKBox's and
# Tmall's RAT_m2 blocks, intra over s and cross over t; ML-Tag's RAT_m0
# joint sequence and RAT_m1's intra and cross Transformers), then edges:
# one token, sequences that do not fill a block, the longest sequence
# and the most (head, token) pairs taken
ATTENTION_CASES = [("kkbox.intra", 24576, 14, 8, 10), ("kkbox.cross", 57344, 6, 8, 10),
                   ("tmall.intra", 24576, 9, 32, 10), ("tmall.cross", 36864, 6, 32, 10),
                   ("mltag.m0_joint", 4096, 24, 2, 10), ("mltag.m1_intra", 24576, 4, 2, 10),
                   ("mltag.m1_cross", 4096, 6, 2, 10), ("edge.seq1", 1000, 1, 8, 10),
                   ("edge.seq13", 3001, 13, 8, 10), ("edge.seq32", 2003, 32, 8, 10),
                   ("edge.pairs512", 1001, 16, 32, 10)]
# calls of the attention op a RAT_m2 forward makes at depth 4 (intra and
# cross in each block); the backward makes as many
ATTENTION_PER_STEP = 8


def attention_bound(n, seq, heads, dim_head, backward=False):
    """(ms, "operations" or "bytes") of the least time of one call: the
    forward reads qkv and writes out (2 products of seq^2 x dim_head per
    head); the backward reads qkv and d(out) and writes d(qkv) (the
    scores again and 4 gradient products)."""
    inner = heads * dim_head
    flops = 2 * n * heads * seq * seq * dim_head * (5 if backward else 2)
    floats = n * seq * (7 * inner if backward else 4 * inner)
    return _bound(flops, 4 * floats)


def check_attention(rng, device, reps=20):
    """The attention kernel (ops.attention) against its plain version at
    ATTENTION_CASES: the output within rtol 1e-4 / atol 1e-5 and d(qkv)
    (one random cotangent) within rtol 2e-3 / atol 1e-4, K1's tolerances;
    a second call of each bit-equal to the first. Then per case the
    device ms of the forward and backward kernels, CUDA-event ms of
    forward and forward+backward of the kernel, the plain version and
    torch's scaled_dot_product_attention (a yardstick the port never
    calls), and the bounds. Returns the ``kernels`` entry."""
    F = torch.nn.functional
    out = {}
    for name, n, seq, heads, dim_head in ATTENTION_CASES:
        inner = heads * dim_head
        if attn.path("cuda", torch.float32, seq, heads, dim_head) != "kernel":
            raise AssertionError("attention {}: the kernel does not take it".format(name))
        qkv = torch.from_numpy(2 * rng.randn(n, seq, 3 * inner).astype(np.float32)).to(device)
        g = torch.from_numpy(rng.randn(n, seq, inner).astype(np.float32)).to(device)
        qkv.requires_grad_()

        def fwd_bwd(fn, qkv=qkv, g=g, heads=heads, dim_head=dim_head):
            y = fn(qkv, heads, dim_head)
            return y.detach(), torch.autograd.grad(y, qkv, g)[0]

        before = (attn.launches, attn.grad_launches)
        got, again = fwd_bwd(attn.attention), fwd_bwd(attn.attention)
        want = fwd_bwd(attn.attention_reference)
        torch.cuda.synchronize()
        if (attn.launches, attn.grad_launches) != (before[0] + 2, before[1] + 2):
            raise AssertionError("attention {}: the kernels did not run".format(name))
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        ok = bool(((got[0] - want[0]).abs() <= 1e-5 + 1e-4 * want[0].abs()).all()) and \
            bool(((got[1] - want[1]).abs() <= 1e-4 + 2e-3 * want[1].abs()).all())
        bits = all(torch.equal(a, b) for a, b in zip(got, again))
        print("attention {:15s} n={:5d} seq={:2d} h={:2d} dh={:2d}: out max_abs_err {:.3e} "
              "(rtol 1e-4, atol 1e-5), d(qkv) {:.3e} (rtol 2e-3, atol 1e-4) {}, second "
              "call bit-equal: {}".format(name, n, seq, heads, dim_head, errs[0], errs[1],
                                          "ok" if ok else "FAIL", bits))
        if not ok or not bits:
            raise AssertionError("attention {}: the kernel disagrees with its plain "
                                 "version or with itself".format(name))
        del got, again, want
        with torch.no_grad():
            x = qkv.detach()
            q, k, v = (t.reshape(n, seq, heads, dim_head).transpose(1, 2)
                       for t in x.chunk(3, dim=-1))
            res = {"n": n, "seq": seq, "heads": heads, "dim_head": dim_head,
                   "ms": _kernel_ms(lambda: attn.attention(x, heads, dim_head), reps,
                                    "attention_fwd_kernel"),
                   "call_ms": _cuda_ms(lambda: attn.attention(x, heads, dim_head), reps),
                   "plain_ms": _cuda_ms(lambda: attn.attention_reference(x, heads, dim_head),
                                        reps),
                   "library_ms": _cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                          reps)}
        res["grad_ms"] = _kernel_ms(lambda: fwd_bwd(attn.attention), reps,
                                    "attention_bwd_kernel")
        res["fwd_bwd_ms"] = _cuda_ms(lambda: fwd_bwd(attn.attention), reps)
        res["plain_fwd_bwd_ms"] = _cuda_ms(lambda: fwd_bwd(attn.attention_reference), reps)
        qkv_h = [t.detach().reshape(n, seq, heads, dim_head).transpose(1, 2).requires_grad_()
                 for t in qkv.chunk(3, dim=-1)]
        g_h = g.reshape(n, seq, heads, dim_head).transpose(1, 2)
        res["library_fwd_bwd_ms"] = _cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*qkv_h), qkv_h, g_h), reps)
        res["bound_ms"], res["bound_by"] = attention_bound(n, seq, heads, dim_head)
        res["grad_bound_ms"], res["grad_bound_by"] = attention_bound(n, seq, heads, dim_head,
                                                                     backward=True)
        out[name] = res
        print("attention {:15s} forward {ms:.4f} ms on the device ({call_ms:.4f} a call), "
              "bound {bound_ms:.4f} ({bound_by}), plain {plain_ms:.4f}, library "
              "{library_ms:.4f}; backward kernel {grad_ms:.4f} ms, bound {grad_bound_ms:.4f} "
              "({grad_bound_by}); forward+backward {fwd_bwd_ms:.4f} ms a call, plain "
              "{plain_fwd_bwd_ms:.4f}, library {library_fwd_bwd_ms:.4f}".format(name, **res))
        del qkv, g, x, q, k, v, qkv_h, g_h
    return {"name": "attention", "route": "cuda", "source": "rat_tpu_torch/csrc/attention.cu",
            "replaces": None, "shapes": out}


def _emb_grad_cases(seed, batch=4096, samples=6):
    """(cell, table, ids [batch, samples, ...], rows, d) of the lookups
    in one train step of each train cell, from rows drawn as the ML-Tag
    and KKBox phases draw theirs."""
    n = batch * samples
    cases = []
    for cell, (x, _), fm, d in (
            ("mltag", mltag_arrays(seed, n, 0), mltag_feature_map(), 10),
            ("kkbox", kkbox_arrays(seed, n, 0), kkbox_feature_map(), 40)):
        X = torch.from_numpy(x[:, :-1].astype(np.int64)).view(batch, samples, -1)
        labels = torch.from_numpy(x[:, -1].astype(np.int64)).view(batch, samples)
        labels[:, 0] = 2
        spec = EmbeddingSpec.build(fm, d)
        wide = EmbeddingSpec.build(fm, 1, use_pretrain=False, force_dim=1)
        for name, s, ids, width in (("packed", spec, X, d), ("wide", wide, X[:, :1], 1)):
            rows = ids[..., torch.from_numpy(s.token_cols)] + torch.from_numpy(s.token_offsets)
            cases.append((cell, name, rows, s.total_rows, width))
        cases.append((cell, "label", labels, 3, d))
    return cases


def check_emb_grad(seed, device, reps=20):
    """The embedding lookups' backward at the train cells' shapes: the
    kernel's table gradient equal to index_put_'s and to PyTorch's
    embedding_dense_backward's (quarter-integer gradients, so every sum
    is exact), then all three timed. Returns the ``kernels`` entry
    {name, shapes: {cell.table: {n, rows, d, longest_run, ms, call_ms,
    plain_ms, library_ms, library_call_ms, bound_ms}}}."""
    rng = np.random.RandomState(seed)
    out = {}
    for cell, name, rows, num_rows, d in _emb_grad_cases(seed):
        rows = rows.to(device)
        grad = torch.from_numpy((rng.randint(-8, 8, tuple(rows.shape) + (d,)) / 4)
                                .astype(np.float32)).to(device)
        before = emb_grad.launches
        got = emb_grad.table_grad(grad, rows, num_rows)
        want = emb_grad.table_grad_reference(grad, rows, num_rows)

        def library():
            return torch.ops.aten.embedding_dense_backward(grad, rows, num_rows, -1, False)

        lib = library()
        torch.cuda.synchronize()
        if emb_grad.launches != before + 1 or not torch.equal(got, want) \
                or not torch.equal(lib, want):
            raise AssertionError("emb grad {}.{}: the kernel's, index_put_'s and "
                                 "embedding_dense_backward's gradients differ"
                                 .format(cell, name))
        n = rows.numel()
        res = {"n": n, "rows": num_rows, "d": d,
               "longest_run": int(torch.bincount(rows.reshape(-1)).max()),
               # every kernel and copy of a call: its sort's too
               "ms": _kernel_ms(lambda: emb_grad.table_grad(grad, rows, num_rows), reps, ""),
               "call_ms": _cuda_ms(lambda: emb_grad.table_grad(grad, rows, num_rows), reps),
               "plain_ms": _cuda_ms(
                   lambda: emb_grad.table_grad_reference(grad, rows, num_rows), reps),
               "library_ms": _kernel_ms(library, reps, ""),
               "library_call_ms": _cuda_ms(library, reps),
               "bound_ms": _bound(0, 4 * d * (n + num_rows))[0]}
        out[cell + "." + name] = res
        print("emb grad {:6s} {:6s} n={:7d} rows={:6d} d={:2d} longest run {:6d}: equal to "
              "index_put_ and embedding_dense_backward; {ms:.4f} ms on the device "
              "({call_ms:.4f} ms a call), index_put_ {plain_ms:.4f} ms, "
              "embedding_dense_backward {library_ms:.4f} ms on the device "
              "({library_call_ms:.4f} ms a call), bound {bound_ms:.4f} ms (bytes)".format(
                  cell, name, n, num_rows, d, res["longest_run"], **res))
    return {"name": "embedding_grad", "shapes": out}


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


def _fold_size(n, retrieval):
    return -(-n // int(retrieval["split_type"].split("-")[0]))


def _fold_k2_batches(n, retrieval):
    """K2 launches of the X-fold self-retrieval of an n-row split."""
    fold_size = _fold_size(n, retrieval)
    return sum(_k2_batches(min(fold_size, n - lo), retrieval)
               for lo in range(0, n, fold_size))


def check_fold_cache(split, cache_path, retrieval, device, phase):
    """The cached neighbours of fold 0 of an X-fold self-retrieval of
    ``split`` (they come from the rows after fold 0) against the plain
    scan's, as :func:`check_neighbours`."""
    cached = np.load(cache_path)
    fold_size = _fold_size(len(split), retrieval)
    shifted = types.SimpleNamespace(
        retr_indices=np.where(cached["indices"] >= 0, cached["indices"] - fold_size, -1),
        retr_values=cached["values"], retr_lens=cached["lens"])
    return check_neighbours(shifted, split[fold_size:], split[:fold_size], retrieval,
                            device, phase)


def train(device, seed, pool, test, batch_size, model_root):
    """The training path as a user drives it: the pool rows as the train
    split with X-fold self-retrieval, the request rows as the valid split
    retrieved against it, a one-step check, Trainer.fit for one epoch,
    then the best checkpoint reloaded and evaluated. Launch counts are
    zeroed just before and read just after the generators (K2) and the
    fit (K1). On a card the fit's one step graph replays every train
    batch but its first, the tail before the evaluation included.
    Returns (trainer, train generator, dict of results)."""
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

    k1.launches = emb_grad.launches = 0
    sync()
    t3 = time.perf_counter()
    trainer.fit(train_gen, valid_gen, epochs=1)
    sync()
    t4 = time.perf_counter()
    k1_launches, emb_launches = k1.launches, emb_grad.launches
    replays = _replays(trainer)
    if replays != (len(train_gen) - 1 if cuda else 0):
        raise AssertionError("train: the step graph replayed {} of {} batches".format(
            replays, len(train_gen)))

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
    depth = trainer.model.depth
    expected = {"cross_intra_block": depth * (len(train_gen) + len(valid_gen)),
                "bm25_topk": _fold_k2_batches(len(pool), retrieval)
                + _k2_batches(len(test), retrieval),
                "embedding_grad": EMB_GRAD_PER_STEP * len(train_gen)} if cuda \
        else {"cross_intra_block": 0, "bm25_topk": 0, "embedding_grad": 0}
    launches = {"cross_intra_block": k1_launches, "bm25_topk": k2_launches,
                "embedding_grad": emb_launches}
    if launches != expected:
        raise AssertionError("train: launches {} against the expected {}".format(
            launches, expected))
    return trainer, train_gen, dict(
        {"train_rows": len(pool), "valid_rows": len(test), "steps": len(losses),
         "valid_batches": len(valid_gen), "depth": depth, "replays": replays,
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
    the blocks' backward (K1's backward kernel, or autograd of the plain
    block at shapes it does not take), and the idle share."""
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
        print("{} profile: K1 forward kernel {:.3f} ms, block backward {:.3f} ms of "
              "device time".format(
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
    scan's, the card's eval-mode logits of 512 valid rows within 1e-5 of
    the same weights run on the CPU (a reference run), and on a card the
    attention kernel's launches: ATTENTION_PER_STEP forward and backward
    a train step, as many forward an eval batch, none plain. Returns
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
    k1.launches = emb_grad.launches = 0
    attn.launches = attn.grad_launches = attn.plain = 0
    sync()
    t3 = time.perf_counter()
    trainer.fit(train_gen, valid_gen, epochs=1)
    sync()
    t4 = time.perf_counter()
    k1_launches, emb_launches = k1.launches, emb_grad.launches
    # the fit: every train step's forward and backward and the epoch's
    # evaluation; then the reload's evaluation and the logits' forward
    attn_fit = {"forward": attn.launches, "backward": attn.grad_launches,
                "plain": attn.plain}

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

    per = ATTENTION_PER_STEP if cuda else 0
    steps, batches = len(train_gen), len(valid_gen)
    expected = {"cross_intra_block": 0,
                "bm25_topk": _fold_k2_batches(len(train), retrieval)
                + _k2_batches(len(valid), retrieval) if cuda else 0,
                "embedding_grad": EMB_GRAD_PER_STEP * len(train_gen) if cuda else 0,
                "attention_fit": {"forward": per * (steps + batches),
                                  "backward": per * steps, "plain": 0},
                "attention": {"forward": per * (steps + 2 * batches + 1),
                              "backward": per * steps, "plain": 0}}
    launches = {"cross_intra_block": k1_launches, "bm25_topk": k2_launches,
                "embedding_grad": emb_launches, "attention_fit": attn_fit,
                "attention": {"forward": attn.launches, "backward": attn.grad_launches,
                              "plain": attn.plain}}
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


# the grouped phase: groups of the JAX package's default size; float32
# bounds of a graphed run against the per-step run from the same state,
# used where twice the spread of two per-step runs is smaller: step
# losses within 2e-4 (test_fit_trajectory_matches_jax's tolerance for
# float32 differences compounding over steps), every parameter and
# buffer within 2 x lr = 2e-3 (Adam moves a coordinate by about lr a
# step, so float32 noise that flips the sign of a near-zero gradient
# coordinate moves it by up to 2 lr; a skipped or doubled batch moves
# the later losses by more than 2e-4); eval predictions within 1e-6
# (a few float32 ulps of a sigmoid output, should the capture's stream
# get other cuBLAS kernels: the graph replays the same K1 and model)
GROUP = 64
GROUPED_LOSS_ATOL = 2e-4
GROUPED_STATE_ATOL = 2e-3
GROUPED_PRED_ATOL = 1e-6


def _train_state(trainer):
    """A copy of the trainer's weights and buffers, optimizer state and
    dropout generator state."""
    return ({k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            copy.deepcopy(trainer.optimizer.state_dict()),
            trainer.dropout_generator.get_state())


def _set_train_state(trainer, state):
    model, opt, gen = state
    trainer.load_model_state(model)
    trainer._load_optimizer_state(copy.deepcopy(opt))
    trainer.dropout_generator.set_state(gen)


def _host_batches(gen, seed, n):
    order = gen.epoch_index_batches(rng=np.random.RandomState(seed))
    return [b for b, _ in zip(order, range(n))]


def _run_steps(trainer, batches, group, decay_at=None):
    """Train on ``batches`` (host row ids, valid) from the trainer's state
    over its train split: per step (``group`` 0: each batch's ids
    uploaded with a blocking copy, then one Trainer.train_step) or in
    groups through Trainer.train_scan (one pinned upload per group);
    the LR plateau's decay (Trainer.lr_decay) after ``decay_at`` batches.
    Returns (host losses, host ms per step, ending in a synchronize)."""
    data, dev = trainer._train_data, trainer.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    cut = len(batches) if decay_at is None else decay_at
    for k, part in enumerate((batches[:cut], batches[cut:])):
        if k and decay_at is not None:
            trainer.lr_decay()
        if group:
            losses += [trainer.train_scan(data, trainer._upload(np.stack([i for i, _ in g])),
                                          [v for _, v in g])
                       for g in (part[j:j + group] for j in range(0, len(part), group))]
        else:
            losses += [trainer.train_step(data, torch.from_numpy(i).to(dev), v)
                       for i, v in part]
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    return torch.cat([x.reshape(-1) for x in losses]).cpu().numpy(), ms


def _state_err(a, b):
    """The largest |difference| over every weight and buffer of two state
    dicts."""
    return max(float((a[k].double() - b[k].double()).abs().max()) if a[k].numel() else 0.0
               for k in a)


def _moments(trainer):
    """The optimizer's state tensors (Adam's moments and step), keyed by
    parameter position and name."""
    return {"{}/{}".format(i, key): v.detach().cpu().clone()
            for i, slot in trainer.optimizer.state_dict()["state"].items()
            for key, v in slot.items() if torch.is_tensor(v)}


def _runs_from(trainer, state, batches, arms, decay_at):
    """``batches`` from the saved ``state`` once per arm (name, group:
    0 per step, else groups through Trainer.train_scan), each with the
    LR plateau's decay after ``decay_at`` batches: {name: losses, host
    ms per step, K1's launches, the final LR, weights and buffers, the
    optimizer's moments}."""
    runs = {}
    for name, group in arms:
        _set_train_state(trainer, state)
        k1.launches = 0
        losses, ms = _run_steps(trainer, batches, group, decay_at=decay_at)
        runs[name] = {"losses": losses, "host_ms_per_step": ms, "k1": k1.launches,
                      "lr": get_learning_rate(trainer.optimizer),
                      "state": {k: v.detach().cpu().clone()
                                for k, v in trainer.model.state_dict().items()},
                      "moments": _moments(trainer)}
    return runs


def _run_err(a, b):
    """The largest |difference| between two runs of :func:`_runs_from`:
    step losses, weights and buffers, optimizer moments."""
    if len(a["losses"]) != len(b["losses"]) or sorted(a["moments"]) != sorted(b["moments"]):
        raise AssertionError("two runs of other lengths or other optimizer state")
    return {"loss": float(np.abs(a["losses"] - b["losses"]).max()),
            "state": _state_err(a["state"], b["state"]),
            "moments": _state_err(a["moments"], b["moments"])}


def _replays(trainer, kind="train"):
    graph = trainer._graphs.get(kind)
    return graph.replays if graph is not None else 0


def _window(trainer, batches, group, profiled):
    """One more run of ``batches`` from the current state (the graph, if
    any, already captured): host ms per step, and under torch.profiler
    (device activity only) device ms per step and the idle share of the
    window's wall time; None where the profiler saw no device time."""
    if not profiled or trainer.device.type != "cuda":
        return {"host_ms_per_step": _run_steps(trainer, batches, group)[1]}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ms = _run_steps(trainer, batches, group)
    busy = sum(e.self_device_time_total for e in _device_events(prof.key_averages())) / 1e3
    wall = ms * len(batches)
    seen = busy > 0.05 * wall
    return {"profiled_host_ms_per_step": ms,
            "device_ms_per_step": busy / len(batches) if seen else None,
            "idle_share": 1 - busy / wall if seen else None}


def _eval_per_batch(trainer, gen, data):
    """Scores of ``gen`` one batch per dispatch, each batch's ids uploaded
    with a blocking copy and each batch's scores kept on the device until
    the end (an eval of one batch a dispatch; under a mesh, of one rank,
    this rank's rows); host float32."""
    model, dev = trainer.model, trainer.device
    model.eval()
    preds = []
    with torch.no_grad():
        for idx, valid in gen.epoch_index_batches():
            idx = torch.from_numpy(idx).to(dev)
            if trainer.mesh is not None:
                idx = process_local_rows(idx, trainer.mesh)
            out = trainer._forward(data, idx)
            preds.append(out["y_pred"][:valid, 0])
    return torch.cat(preds).cpu().numpy()


def grouped(trainer, train_gen, valid_gen, kk_trainer, kk_gen, seed, group=GROUP,
            groups=2, kk_steps=8, window=GROUP):
    """Grouped dispatch against per-step dispatch on the trainers of the
    train (ML-Tag, fused path) and kkbox_train (module path, BatchNorm,
    embedding dropout) phases, their uploaded splits and neighbours, no
    new retrieval. From one saved state (weights, Adam, the dropout
    generator): ``groups`` x ``group`` steps per step, again per step,
    then grouped through Trainer.train_scan (on a card a CUDA graph of
    the step's forward and backward, replayed, the optimizer stepping
    after each; its first batch eager), each run with the LR plateau's
    decay after its first group. Step losses and final weights and
    buffers: the grouped run within the larger of twice the per-step
    runs' spread and the float32 bounds above, at the same final LR. K1's launches in
    the grouped run = depth x steps. Windows of ``window`` steps each way
    for host ms per step, device ms per step and the idle share. The
    valid split scored per batch and through Trainer.predict (grouped,
    the eval graph), in turns: predictions within 1e-6, examples/s. The
    KKBox trainer: ``kk_steps`` steps eagerly and as one graphed group
    from one state (BatchNorm's statistics and the dropout masks in the
    graph), or the gate's reason where the graph is closed. The ML-Tag
    steps once more with ``dedup_neighbors`` (the fixed-size unique's
    gather), per step and graphed: both equal bit for bit to each other
    and to the plain per-step run (losses, weights, buffers, Adam's
    moments), K1 = depth x steps in n - 1 replays, and a profiled window
    of the graphed steps. Every trainer is put back in its saved state. Returns
    (results, the grouped runs' launches: the graphed plain and dedup
    runs and the grouped evaluations)."""
    cuda = trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    depth = trainer.model.depth
    n = groups * group
    batches = _host_batches(train_gen, seed, n + 2 * window)
    state = _train_state(trainer)
    runs = _runs_from(trainer, state, batches[:n],
                      (("per_step_a", 0), ("per_step_b", 0), ("grouped", group)), group)
    a, b, g = runs["per_step_a"], runs["per_step_b"], runs["grouped"]
    replays = _replays(trainer)
    spread, err = _run_err(a, b), _run_err(g, a)
    bound = {"loss": max(2 * spread["loss"], GROUPED_LOSS_ATOL),
             "state": max(2 * spread["state"], GROUPED_STATE_ATOL),
             "moments": max(2 * spread["moments"], GROUPED_STATE_ATOL)}
    if len(g["losses"]) != n or not all(err[k] <= bound[k] for k in err) \
            or g["lr"] != a["lr"]:
        raise AssertionError("grouped: the grouped run differs from the per-step run by "
                             "{} (bounds {}, per-step spread {})".format(err, bound, spread))
    want_k1 = depth * n if cuda else 0
    if g["k1"] != want_k1 or (cuda and replays != n - 1):
        raise AssertionError("grouped: K1 launched {} times in {} replays, expected depth x "
                             "steps = {} in {}".format(g["k1"], replays, want_k1, n - 1))
    gate = trainer._graph_gate("train")
    res = {"steps": n, "group": group, "graph": gate is None, "gate": gate,
           "replays": replays, "k1_launches": g["k1"], "lr_after_decay": g["lr"],
           "bit_equal": not any(err.values()),
           "spread_per_step": spread, "grouped_vs_per_step": err, "bounds": bound,
           "host_ms_per_step": {"per_step": a["host_ms_per_step"],
                                "per_step_again": b["host_ms_per_step"],
                                "grouped_with_capture": g["host_ms_per_step"]}}

    # steady windows (the graph captured): in turns, then profiled
    more = [batches[n:n + window], batches[n + window:]]
    steady = {"per_step": [], "grouped": []}
    for name, part in (("per_step", 0), ("grouped", 1), ("grouped", 1), ("per_step", 0)):
        steady[name].append(_window(trainer, more[part], group if name == "grouped" else 0,
                                    False)["host_ms_per_step"])
    res["steady_host_ms_per_step"] = steady
    res["profiled"] = {name: _window(trainer, more[0], grp, True)
                       for name, grp in (("per_step", 0), ("grouped", group))}

    # evaluation: per batch and grouped (the eval graph), in turns
    data = trainer._valid_data
    evals = {"per_batch": [], "grouped": []}
    preds = {"per_batch": [], "grouped": []}
    eval_k1 = 0
    for name in ("per_batch", "grouped", "grouped", "per_batch"):
        k1.launches = 0
        sync()
        t0 = time.perf_counter()
        if name == "per_batch":
            pred = _eval_per_batch(trainer, valid_gen, data)
        else:
            pred = trainer.predict(valid_gen, data).astype(np.float32)
        sync()
        evals[name].append(len(pred) / (time.perf_counter() - t0))
        if name == "grouped":
            eval_k1 += k1.launches
        if k1.launches != (depth * len(valid_gen) if cuda else 0):
            raise AssertionError("grouped: eval {} launched K1 {} times".format(
                name, k1.launches))
        preds[name].append(pred)
    want = preds["per_batch"][0]
    pred_err = max(float(np.abs(p - want).max()) for p in preds["grouped"] + preds["per_batch"])
    if any(p.shape != want.shape for p in preds["grouped"]) or pred_err > GROUPED_PRED_ATOL:
        raise AssertionError("grouped: grouped eval predictions differ from per-batch "
                             "ones by {}".format(pred_err))
    res["eval"] = {"rows": valid_gen.num_samples, "batches": len(valid_gen),
                   "examples_per_s": evals, "pred_max_abs_err": pred_err,
                   "pred_bit_equal": pred_err == 0.0,
                   "graph": trainer._graph_gate("eval") is None}

    # dedup_neighbors (the fixed-size unique's gather) on the same steps,
    # per step and graphed: equal to each other and to the plain runs
    trainer._dedup = True
    try:
        d = _runs_from(trainer, state, batches[:n], (("per_step", 0), ("grouped", group)),
                       group)
        d_replays, d_gate = _replays(trainer), trainer._graph_gate("train")
        d_prof = _window(trainer, more[0], group, True)
    finally:
        trainer._dedup = False
        trainer._graphs.pop("train", None)
    d_err, d_plain = _run_err(d["grouped"], d["per_step"]), _run_err(d["per_step"], a)
    if any(d_err.values()) or any(d_plain.values()) or d["grouped"]["lr"] != a["lr"]:
        raise AssertionError("grouped: dedup_neighbors' graphed run differs from its "
                             "per-step run by {}, which differs from the plain per-step "
                             "run by {}".format(d_err, d_plain))
    if d["grouped"]["k1"] != want_k1 or (cuda and (d_replays != n - 1 or d_gate)):
        raise AssertionError("grouped: dedup_neighbors' graphed run launched K1 {} times "
                             "in {} replays, expected {} in {}".format(
                                 d["grouped"]["k1"], d_replays, want_k1, n - 1))
    res["dedup"] = {"steps": n, "graph": d_gate is None, "gate": d_gate,
                    "replays": d_replays, "k1_launches": d["grouped"]["k1"],
                    "bit_equal": True, "equal_to_plain": True,
                    "host_ms_per_step": {"per_step": d["per_step"]["host_ms_per_step"],
                                         "grouped_with_capture":
                                             d["grouped"]["host_ms_per_step"]},
                    "profiled": d_prof}
    _set_train_state(trainer, state)

    # KKBox's module path: BatchNorm and dropout masks in the graph
    kk_state = _train_state(kk_trainer)
    kk_batches = _host_batches(kk_gen, seed, kk_steps)
    kk = {}
    for name, g_size in (("eager", 0), ("grouped", kk_steps)):
        _set_train_state(kk_trainer, kk_state)
        losses, ms = _run_steps(kk_trainer, kk_batches, g_size)
        kk[name] = {"losses": losses, "ms": ms,
                    "state": {k: v.detach().cpu().clone()
                              for k, v in kk_trainer.model.state_dict().items()},
                    "generator": kk_trainer.dropout_generator.get_state()}
    kk_gate = kk_trainer._graph_gate("train")
    kk_err = {"loss": float(np.abs(kk["grouped"]["losses"] - kk["eager"]["losses"]).max()),
              "state": _state_err(kk["grouped"]["state"], kk["eager"]["state"])}
    if kk_err["loss"] > GROUPED_LOSS_ATOL or kk_err["state"] > GROUPED_STATE_ATOL:
        raise AssertionError("grouped: the KKBox group differs from its eager steps by "
                             "{}".format(kk_err))
    res["kkbox"] = {"steps": kk_steps, "graph": kk_gate is None, "gate": kk_gate,
                    "dropout": kk_trainer._has_dropout(),
                    "batch_norm": bool(kk_trainer.model.batch_norm),
                    "grouped_vs_eager": kk_err,
                    "bit_equal": kk_err["loss"] == 0 and kk_err["state"] == 0,
                    "generator_state_equal": bool(torch.equal(kk["grouped"]["generator"],
                                                              kk["eager"]["generator"])),
                    "host_ms_per_step": {k: v["ms"] for k, v in kk.items()}}
    _set_train_state(kk_trainer, kk_state)
    return res, {"cross_intra_block": g["k1"] + d["grouped"]["k1"] + eval_k1,
                 "bm25_topk": 0}


def print_grouped(res):
    """The grouped phase's figures, one line each way."""
    host, prof = res["steady_host_ms_per_step"], res["profiled"]

    def fmt(x):
        return "not measured" if x is None else "{:.3f}".format(x)
    for name in ("per_step", "grouped"):
        print("grouped train {} (ML-Tag fused, windows of {} steps): host ms per step "
              "{} (in turns), device ms per step {}, idle share {} (profiled window, host "
              "{:.3f} ms per step)".format(
                  name, GROUP, " / ".join("{:.3f}".format(x) for x in host[name]),
                  fmt(prof[name].get("device_ms_per_step")), fmt(prof[name].get("idle_share")),
                  prof[name].get("profiled_host_ms_per_step", float("nan"))))
    ev = res["eval"]["examples_per_s"]
    print("grouped eval ({} rows): examples/s per batch {} | grouped {}; predictions max "
          "|diff| {:.3e}".format(res["eval"]["rows"], " / ".join("{:.0f}".format(x)
                                                                 for x in ev["per_batch"]),
                                 " / ".join("{:.0f}".format(x) for x in ev["grouped"]),
                                 res["eval"]["pred_max_abs_err"]))
    dd, p = res["dedup"], res["dedup"]["profiled"]
    print("grouped dedup_neighbors ({} steps from one state): host ms per step {:.3f} per "
          "step, {:.3f} {} (capture included); the grouped steps' device ms per step {}, "
          "idle share {} (profiled window, host {} ms per step)".format(
              dd["steps"], dd["host_ms_per_step"]["per_step"],
              dd["host_ms_per_step"]["grouped_with_capture"],
              "graphed" if dd["graph"] else "grouped, no graph: " + str(dd["gate"]),
              fmt(p.get("device_ms_per_step")), fmt(p.get("idle_share")),
              fmt(p.get("profiled_host_ms_per_step"))))
    kk = res["kkbox"]
    print("grouped kkbox ({} steps, BatchNorm {}, dropout {}): {}; against eager {}".format(
        kk["steps"], kk["batch_norm"], kk["dropout"],
        "graphed" if kk["graph"] else "no graph, the gate: " + str(kk["gate"]),
        json.dumps(kk["grouped_vs_eager"])))


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


def mesh_scan(device, pool, test, shards=4, retrieval=MLTAG_RETRIEVAL):
    """Mesh phase (a): the pool-sharded BM25 scan with ``shards`` shards
    run in turn in this process (what each rank of a ``shards``-rank
    world computes: K2 on its shard, then the merge), held equal bit for
    bit to the unsharded retrieval: values, indices and lens. K2's
    launches are counted over the sharded run only. Returns (results,
    launches)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    used = retrieval["used_col_indices"]
    db = pool[:, used].astype(np.int64)
    qry = test[:, used].astype(np.int64)
    kw = {k: retrieval[k] for k in ("qry_batch_size", "db_chunk_size", "topK")}
    want = bm25.bm25_topk_retrieval(db, qry, device=device, **kw)
    timings = {}
    k1.launches = k2.launches = 0
    sync()
    t0 = time.perf_counter()
    got = sharded.sharded_bm25_topk_retrieval(db, qry, n_shards=shards, device=device,
                                              timings=timings, **kw)
    sync()
    total_s = time.perf_counter() - t0
    launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches}
    for name, a, b in zip(("values", "indices", "lens"), got, want):
        if not np.array_equal(a, b):
            raise AssertionError("mesh (a): the sharded {} differ from the unsharded "
                                 "retrieval's".format(name))
    expected = {"cross_intra_block": 0,
                "bm25_topk": shards * _k2_batches(len(qry), retrieval) if cuda else 0}
    if launches != expected:
        raise AssertionError("mesh (a): launches {} against the expected {}".format(
            launches, expected))
    return {"shards": shards, "shard_rows": sharded.shard_rows(len(db), shards,
                                                               kw["topK"], kw["db_chunk_size"]),
            "queries": len(qry), "pool_rows": len(db), "total_s": total_s,
            "shard_scan_s": timings["scan_s"], "merge_s": timings["merge_s"],
            "merge_share": timings["merge_s"] / total_s, "equal": True}, launches


def mesh_graphs(trainer, train_gen, valid_gen, seed, group=GROUP, groups=2,
                window=GROUP // 2, bn_steps=8):
    """The grouped dispatch under the mesh of ``trainer`` (one rank): from
    one saved state, ``groups`` x ``group`` steps per step (the mesh's
    per-step path, its collectives eager) and graphed (Trainer.train_scan:
    the step's forward and backward captured with the gradients' and the
    loss's all-reduces, the clip's reduction eager after each replay),
    the LR plateau's decay between the groups in each: equal bit for bit
    (losses, weights, buffers, Adam's moments, the LR), K1 = depth x
    steps in each, n - 1 replays. Host ms per step in turns (per step,
    graphed, graphed, per step) over ``window`` more steps, then a
    profiled window each way (device ms per step, idle share). The valid
    split per batch and through Trainer.predict (the eval graph, gathered
    over the data group) in turns: equal bit for bit, K1 = depth x
    batches in each. A BatchNorm trainer of the same config on the same
    mesh and split (the module path: BatchNorm's all-reduces of the
    forward and the backward captured): ``bn_steps`` steps eagerly and as
    one graphed group from one state, equal bit for bit. The trainer is
    put back in its saved state. Returns (results, K1's launches of the
    graphed train run and the graphed evaluations)."""
    cuda = trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    depth = trainer.model.depth
    n = groups * group
    batches = _host_batches(train_gen, seed, n + window)
    state = _train_state(trainer)
    runs = _runs_from(trainer, state, batches[:n], (("per_step", 0), ("graphed", group)),
                      group)
    per, graphed = runs["per_step"], runs["graphed"]
    replays, gate = _replays(trainer), trainer._graph_gate("train")
    err = _run_err(graphed, per)
    want_k1 = depth * n if cuda else 0
    if any(err.values()) or graphed["lr"] != per["lr"]:
        raise AssertionError("mesh (b): the graphed steps differ from the mesh's per-step "
                             "steps by {}".format(err))
    if per["k1"] != want_k1 or graphed["k1"] != want_k1 or \
            (cuda and (replays != n - 1 or gate)):
        raise AssertionError("mesh (b): K1 launched {} / {} times (per step / graphed) in "
                             "{} replays, expected {} in {}".format(
                                 per["k1"], graphed["k1"], replays, want_k1, n - 1))
    res = {"steps": n, "group": group, "graph": gate is None, "gate": gate,
           "replays": replays, "k1_launches": graphed["k1"], "bit_equal": True,
           "lr_after_decay": graphed["lr"],
           "host_ms_per_step": {"per_step": per["host_ms_per_step"],
                                "graphed_with_capture": graphed["host_ms_per_step"]}}
    steady = {"per_step": [], "graphed": []}
    for name in ("per_step", "graphed", "graphed", "per_step"):
        steady[name].append(_window(trainer, batches[n:], group if name == "graphed" else 0,
                                    False)["host_ms_per_step"])
    res["steady_host_ms_per_step"] = steady
    res["profiled"] = {name: _window(trainer, batches[n:], grp, True)
                       for name, grp in (("per_step", 0), ("graphed", group))}

    data = trainer._valid_data
    preds, rates, eval_k1 = {"per_batch": [], "graphed": []}, {"per_batch": [], "graphed": []}, 0
    for name in ("per_batch", "graphed", "graphed", "per_batch"):
        k1.launches = 0
        sync()
        t0 = time.perf_counter()
        pred = _eval_per_batch(trainer, valid_gen, data) if name == "per_batch" else \
            trainer.predict(valid_gen, data).astype(np.float32)
        sync()
        rates[name].append(len(pred) / (time.perf_counter() - t0))
        if k1.launches != (depth * len(valid_gen) if cuda else 0):
            raise AssertionError("mesh (b): eval {} launched K1 {} times".format(
                name, k1.launches))
        eval_k1 += k1.launches if name == "graphed" else 0
        preds[name].append(pred)
    want = preds["per_batch"][0]
    if not all(np.array_equal(p, want) for p in preds["graphed"] + preds["per_batch"]):
        raise AssertionError("mesh (b): the graphed evaluation's predictions differ from "
                             "the per-batch ones")
    res["eval"] = {"rows": len(want), "batches": len(valid_gen), "pred_bit_equal": True,
                   "graph": trainer._graph_gate("eval") is None, "examples_per_s": rates}
    _set_train_state(trainer, state)

    # BatchNorm under the mesh: its collectives inside the captured step
    bn = Trainer(trainer.feature_map, dict(trainer.params, batch_norm=True),
                 mesh=trainer.mesh)
    bn._train_data = trainer._train_data
    bn_runs = _runs_from(bn, _train_state(bn), batches[:bn_steps],
                         (("eager", 0), ("graphed", bn_steps)), None)
    bn_err = _run_err(bn_runs["graphed"], bn_runs["eager"])
    if any(bn_err.values()) or bn_runs["graphed"]["k1"] or bn_runs["eager"]["k1"]:
        raise AssertionError("mesh (b): the BatchNorm trainer's graphed group differs from "
                             "its eager steps by {} (K1 {})".format(
                                 bn_err, bn_runs["graphed"]["k1"]))
    res["batch_norm"] = {"steps": bn_steps, "graph": bn._graph_gate("train") is None,
                         "replays": _replays(bn), "bit_equal": True,
                         "host_ms_per_step": {k: v["host_ms_per_step"]
                                              for k, v in bn_runs.items()}}
    if cuda and (res["batch_norm"]["replays"] != bn_steps - 1
                 or not res["batch_norm"]["graph"]):
        raise AssertionError("mesh (b): the BatchNorm group replayed {} times".format(
            res["batch_norm"]["replays"]))
    del bn
    return res, graphed["k1"] + eval_k1


def print_mesh_graphs(res):
    """The mesh's per-step and graphed figures, one line each way."""
    def fmt(x):
        return "not measured" if x is None else "{:.3f}".format(x)
    for name in ("per_step", "graphed"):
        p = res["profiled"][name]
        print("mesh (b) train {} (ML-Tag fused, one-rank NCCL mesh): host ms per step {} "
              "(in turns), device ms per step {}, idle share {} (profiled window, host {} "
              "ms per step)".format(
                  name, " / ".join("{:.3f}".format(x) for x in res["steady_host_ms_per_step"][name]),
                  fmt(p.get("device_ms_per_step")), fmt(p.get("idle_share")),
                  fmt(p.get("profiled_host_ms_per_step"))))
    ev = res["eval"]["examples_per_s"]
    print("mesh (b) eval ({} rows): examples/s per batch {} | graphed {}; predictions equal "
          "bit for bit".format(res["eval"]["rows"],
                               " / ".join("{:.0f}".format(x) for x in ev["per_batch"]),
                               " / ".join("{:.0f}".format(x) for x in ev["graphed"])))
    bn = res["batch_norm"]
    print("mesh (b) BatchNorm ({} steps, module path): {} in {} replays, equal to its eager "
          "steps bit for bit; host ms per step {}".format(
              bn["steps"], "graphed" if bn["graph"] else "no graph", bn["replays"],
              json.dumps(bn["host_ms_per_step"])))


def mesh_train(device, seed, pool, valid_gen, batch_size, work_dir, train_gen, reference,
               timing_steps=10, graph_sizes=None):
    """Mesh phase (b): a one-rank process group (NCCL on the card, gloo on
    the CPU) and a real 1x1 mesh through the mesh code path. The train
    arrays' 10-fold self-retrieval through the sharded engine
    (``sharded_pool_min_rows`` lowered to 1), its cache, written by rank
    0, equal to the unsharded neighbours of ``train_gen``; the first
    step's loss and gradients against the non-mesh Trainer's on the same
    batch (equal bit for bit: a one-rank mesh shards no table and its
    collectives copy); one epoch of
    Trainer.fit (K1 on the local batch; on a card the step graph), the
    evaluation, the weights and the full-state round trips (predictions
    and every leaf equal); :func:`mesh_graphs` (``graph_sizes``: its
    group, groups, window and bn_steps); the steady per-step ms against
    the non-mesh ``reference`` trainer's, in the order reference, mesh,
    mesh, reference (``timing_steps`` steps each). The retrieval's
    seconds include the cache's write by rank 0 and its read back; the
    comparison's own read of the cache is timed apart. Launches are
    counted over the retrieval (K2) and over the fit, evaluations and
    round trips and mesh_graphs' graphed runs (K1). Returns (results,
    launches)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    initialize_distributed(device, "tcp://localhost:{}".format(free_port()), 1, 0)
    try:
        mesh = make_mesh(1, 1)
        fm = mltag_feature_map()
        retrieval = MLTAG_RETRIEVAL
        path = os.path.join(work_dir, "mesh_train.npy")
        np.save(path, pool)
        k1.launches = k2.launches = 0
        sync()
        t0 = time.perf_counter()
        gen = DataGenerator(path, batch_size=batch_size, shuffle=True, feature_map=fm,
                            retrieval_configs=dict(retrieval, mesh=mesh,
                                                   sharded_pool_min_rows=1),
                            retrieval_pool_fname="self", retrieval_augmented=True,
                            device=device)
        sync()
        retrieval_s = time.perf_counter() - t0
        k2_launches = k2.launches
        t0 = time.perf_counter()
        with np.load(retrieval_cache_path(path, retrieval["topK"])) as npz:
            cache = {key: npz[key] for key in ("indices", "values", "lens")}
        cache_read_s = time.perf_counter() - t0
        for key, attr in (("indices", "retr_indices"), ("values", "retr_values"),
                          ("lens", "retr_lens")):
            if not np.array_equal(cache[key], getattr(train_gen, attr)):
                raise AssertionError("mesh (b): the sharded 10-fold cache's {} differ "
                                     "from the unsharded neighbours".format(key))

        params = dict(MLTAG_PARAMS, batch_size=batch_size, seed=seed,
                      model_root=os.path.join(work_dir, "mesh_exps"))
        idx, valid = _train_batches(reference, gen, seed, 1)[0]
        steps = []
        for trainer in (Trainer(fm, params, mesh=mesh), Trainer(fm, params, device=device)):
            steps.append(one_step(trainer, trainer.device_split(gen), idx, valid))
            del trainer
        (loss_m, grads_m, _), (loss_p, grads_p, _) = steps
        if sorted(grads_m) != sorted(grads_p):
            raise AssertionError("mesh (b): the first step's gradients are of other "
                                 "parameters")
        worst = max(float((grads_m[n] - g).abs().max()) for n, g in grads_p.items())
        # a one-rank mesh runs the same operations: equal bit for bit
        if loss_m != loss_p or not all(torch.equal(grads_m[n], g)
                                       for n, g in grads_p.items()):
            raise AssertionError("mesh (b): the first step's loss {} / {} or gradients "
                                 "(worst {:.3e}) differ".format(loss_m, loss_p, worst))
        del steps

        trainer = Trainer(fm, params, mesh=mesh)
        k1.launches = 0
        sync()
        t0 = time.perf_counter()
        trainer.fit(gen, valid_gen, epochs=1)
        sync()
        epoch_s = time.perf_counter() - t0
        logs = trainer.evaluate(valid_gen, data=trainer._valid_data)
        pred = trainer.predict(valid_gen, data=trainer._valid_data)
        ckpt = os.path.join(work_dir, "mesh.model")
        trainer.save_weights(ckpt)
        trainer.load_weights(ckpt)
        if not np.array_equal(pred, trainer.predict(valid_gen, data=trainer._valid_data)):
            raise AssertionError("mesh (b): the weights round trip changed predictions")
        before = local_leaves(trainer)
        trainer.save_train_state(os.path.join(work_dir, "mesh_state"))
        trainer.restore_train_state(os.path.join(work_dir, "mesh_state"))
        after = local_leaves(trainer)
        if len(before) != len(after) or not all(torch.equal(a, b)
                                                for a, b in zip(before, after)):
            raise AssertionError("mesh (b): the full-state round trip changed a leaf")
        sync()
        launches = {"cross_intra_block": k1.launches, "bm25_topk": k2_launches}
        depth = trainer.model.depth
        # the fit's evaluation, evaluate, and the predicts around the reload
        expected = {"cross_intra_block": depth * (len(gen) + 4 * len(valid_gen)),
                    "bm25_topk": _fold_k2_batches(len(pool), retrieval)} if cuda \
            else {"cross_intra_block": 0, "bm25_topk": 0}
        if launches != expected:
            raise AssertionError("mesh (b): launches {} against the expected {}".format(
                launches, expected))
        losses = np.asarray(trainer.step_losses)
        if len(losses) != len(gen) or not np.all(np.isfinite(losses)):
            raise AssertionError("mesh (b): bad step losses")

        graphs, graph_k1 = mesh_graphs(trainer, gen, valid_gen, seed, **(graph_sizes or {}))
        launches["cross_intra_block"] += graph_k1

        batches = _train_batches(trainer, gen, seed, timing_steps + 2)
        ms = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain"):
            runner = reference if name == "plain" else trainer
            ms[name].append(steady_ms_per_step(runner, gen, seed, timing_steps, batches))
        return {"retrieval_s": retrieval_s, "cache_read_s": cache_read_s,
                "first_step_loss": loss_m,
                "first_step_loss_abs_err": abs(loss_m - loss_p),
                "first_step_grad_max_abs_err": worst, "steps": len(losses),
                "epoch_s": epoch_s, "train_dispatch": trainer.train_dispatch(
                    trainer._train_group_size()),
                "AUC": logs["AUC"], "logloss": logs["logloss"],
                "ms_per_step_mesh": ms["mesh"], "ms_per_step_plain": ms["plain"],
                "graphs": graphs}, launches
    finally:
        dist.destroy_process_group()


def _set_key(text, key, value, then=()):
    """``text`` with the one ``key: ...`` line set to ``value``, and the
    lines ``then`` added after it at its indent."""
    pattern = re.compile(r"^( +){}:.*$".format(re.escape(key)), re.M)
    if len(pattern.findall(text)) != 1:
        raise AssertionError("cli: config key {} is not there once".format(key))

    def line(m):
        return "\n".join(["{}{}: {}".format(m.group(1), key, value)]
                         + [m.group(1) + extra for extra in then])
    return pattern.sub(line, text)


def write_cli_config(out_dir, data_root, model_root, csv_dir, epochs, model_lines=(),
                     retrieval_lines=(), batch_size=None):
    """A copy of the ML-Tag config in ``out_dir`` that differs only in
    where data, models and the three CSVs live, in ``epochs``, in the
    added ``use_pallas: true``, in the added ``model_lines`` (model
    config) and ``retrieval_lines`` (its retrieval configs), and, for a
    run on the CPU, in ``batch_size``; every width and setting stays."""
    os.makedirs(out_dir, exist_ok=True)

    def quoted(path):
        return "'{}'".format(path.replace("'", "''"))

    with open(os.path.join(MLTAG_CONFIG, "dataset_config.yaml")) as fh:
        text = _set_key(fh.read(), "data_root", quoted(data_root + "/"))
    for split in ("train", "valid", "test"):
        text = _set_key(text, split + "_data",
                        quoted(os.path.join(csv_dir, split + ".csv")))
    text = _set_key(text, "topK", MLTAG_RETRIEVAL["topK"], then=retrieval_lines)
    with open(os.path.join(out_dir, "dataset_config.yaml"), "w") as fh:
        fh.write(text)
    with open(os.path.join(MLTAG_CONFIG, "model_config.yaml")) as fh:
        text = _set_key(fh.read(), "model_root", quoted(model_root + "/"))
    text = _set_key(text, "epochs", epochs, then=["use_pallas: true"] + list(model_lines))
    if batch_size is not None:
        text = _set_key(text, "batch_size", batch_size)
    with open(os.path.join(out_dir, "model_config.yaml"), "w") as fh:
        fh.write(text)


def _run_cli(config_dir, gpu, timeout):
    """Run the port's CLI as a user does, in a subprocess; returns (its
    stage seconds, its kernel launches, its log, the command's seconds,
    its device memory line)."""
    cmd = [sys.executable, "-m", "rat_tpu_torch.cli.run_expid", "--config", config_dir,
           "--expid", MLTAG_EXPID, "--gpu", str(gpu)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if gpu < 0:
        # one thread: torch's multithreaded CPU reductions may sum in
        # another order from run to run, and the rerun must be exact
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    seconds = time.perf_counter() - t0
    log = out.stdout + out.stderr
    if out.returncode != 0:
        raise AssertionError("cli: {} exited {}:\n{}".format(" ".join(cmd), out.returncode,
                                                             log[-4000:]))
    found = {}
    for key in ("Stage seconds: ", "Kernel launches: ", "Device memory: "):
        lines = [line for line in log.splitlines() if key in line]
        if len(lines) != 1:
            raise AssertionError("cli: no single {!r} line in the log".format(key))
        found[key] = json.loads(lines[0].split(key, 1)[1])
    return (found["Stage seconds: "], found["Kernel launches: "], log, seconds,
            found["Device memory: "])


def _results_metrics(line):
    """{"val": ..., "test": ...} metric fields of a results line."""
    m = re.search(r",\[val\] (.*),\[test\] (.*)$", line.strip())
    if m is None:
        raise AssertionError("cli: bad results line: " + line)
    return {"val": m.group(1), "test": m.group(2)}


def cli(device, seed, work_dir, rows=MLTAG_SPLIT_ROWS, ids=MLTAG_IDS, epochs=2,
        timeout=600):
    """The published ML-Tag experiment as a user runs it: ML-Tag-sized
    CSVs written by the port's make_mltag_like, a copy of the config
    (paths, ``epochs``, ``use_pallas: true``), then ``python -m
    rat_tpu_torch.cli.run_expid`` twice as a subprocess. The first run
    builds the dataset from the CSVs, retrieves the train split's
    neighbours fold by fold and the valid and test splits' against it
    (K2), trains (K1 in every step and evaluation), reloads the best
    weights, evaluates valid and test and writes the results line. The
    second must build nothing, retrieve nothing (K2 = 0, caches read)
    and give the same metrics exactly. Checks: the launch counts, the
    vocabularies, the train split's cached neighbours of 512 queries
    against the plain scan, AUC above 0.5. Returns a dict of results."""
    cuda = torch.device(device).type == "cuda"
    gpu = (torch.device(device).index or 0) if cuda else -1
    csv_dir = os.path.join(work_dir, "csv")
    data_root, model_root = os.path.join(work_dir, "data"), os.path.join(work_dir, "exps")
    config_dir = os.path.join(work_dir, "config")
    n_train, n_valid, n_test = rows
    t0 = time.perf_counter()
    make_mltag_like(csv_dir, n_train=n_train, n_valid=n_valid, n_test=n_test,
                    seed=seed, **ids)
    csv_s = time.perf_counter() - t0
    write_cli_config(config_dir, data_root, model_root, csv_dir, epochs)

    runs = [_run_cli(config_dir, gpu, timeout) for _ in range(2)]
    (stages, launches, log, seconds, _), (stages2, launches2, log2, seconds2, _) = runs
    dataset_id = MLTAG_EXPID.replace("RAT_m2_", "")
    data_dir = os.path.join(data_root, dataset_id)
    if "build" not in stages or "build" in stages2 or "Fit feature encoder" in log2:
        raise AssertionError("cli: the first run must build the dataset, the second not")
    encoders = [json.loads(line.split("Host encoder: ", 1)[1])
                for line in (log + log2).splitlines() if "Host encoder: " in line]
    # ML-Tag's id columns are floats: the native encoder takes only string
    # vocabularies, as in the JAX package
    if encoders != [{"category": "python"}]:
        raise AssertionError("cli: host encoders {}, expected one build with python "
                             "for the float categories".format(encoders))
    if "fold retrieval: process" not in log or "fold retrieval: process" in log2:
        raise AssertionError("cli: the first run must retrieve, the second read caches")
    with open(os.path.join(model_root, dataset_id, MLTAG_EXPID + ".csv")) as fh:
        lines = fh.read().splitlines()
    if len(lines) != 2:
        raise AssertionError("cli: {} results lines, expected 2".format(len(lines)))
    metrics = [_results_metrics(line) for line in lines]
    if metrics[0] != metrics[1]:
        raise AssertionError("cli: the rerun gave other metrics: {}".format(metrics))
    auc = float(re.search(r"AUC: ([0-9.]+)", metrics[0]["val"]).group(1))
    if not auc > 0.5:
        raise AssertionError("cli: valid AUC {} is not above 0.5".format(auc))

    with open(os.path.join(data_dir, "feature_map.json")) as fh:
        specs = json.load(fh)["feature_specs"]
    vocab = {name: spec["vocab_size"] for name, spec in specs.items()}
    if ids == MLTAG_IDS and vocab != MLTAG_VOCAB:
        raise AssertionError("cli: vocabularies {} against ML-Tag's {}".format(
            vocab, MLTAG_VOCAB))
    train_path = os.path.join(data_dir, "train.npy")
    retrieval = MLTAG_RETRIEVAL
    n_chk = check_fold_cache(np.load(train_path),
                             retrieval_cache_path(train_path, retrieval["topK"]),
                             retrieval, device, "cli")

    batch = MLTAG_PARAMS["batch_size"]
    steps, valid_batches, test_batches = (-(-n // batch) for n in rows)
    n_epochs = len(stages["epochs"])
    k2_first = _fold_k2_batches(n_train, retrieval) \
        + _k2_batches(n_valid, retrieval) + _k2_batches(n_test, retrieval)
    k1_run = MLTAG_PARAMS["depth"] * (n_epochs * (steps + valid_batches)
                                      + valid_batches + test_batches)
    expected = [{"cross_intra_block": k1_run if cuda else 0,
                 "bm25_topk": k2_first if cuda else 0, "bm25_score_chunk": 0},
                {"cross_intra_block": k1_run if cuda else 0, "bm25_topk": 0,
                 "bm25_score_chunk": 0}]
    if [launches, launches2] != expected or len(stages2["epochs"]) != n_epochs:
        raise AssertionError("cli: launches {} against the expected {}".format(
            [launches, launches2], expected))
    return {"rows": list(rows), "vocab": vocab, "epochs": n_epochs,
            "csv_write_s": csv_s, "build_s": stages["build"],
            "build_split_s": {k: stages["build_" + k] for k in
                              ("csv_read", "fit", "transform", "npy_write")},
            "host_encoder": encoders[0],
            "train_retrieval_s": stages["train_retrieval"],
            "valid_retrieval_s": stages["valid_retrieval"],
            "test_retrieval_s": stages["test_retrieval"],
            "epoch_s": stages["epochs"], "valid_evaluation_s": stages["valid_evaluation"],
            "test_evaluation_s": stages["test_evaluation"], "command_s": seconds,
            "rerun": {"train_retrieval_s": stages2["train_retrieval"],
                      "epoch_s": stages2["epochs"], "command_s": seconds2},
            "results_line": lines[0], "neighbours_checked": n_chk,
            "launches": launches, "rerun_launches": launches2}


def _block_sizes(n, block_rows):
    return [min(block_rows, n - lo) for lo in range(0, n, block_rows)]


def _split_bytes(rows, pool_rows, fields, topk):
    """Bytes the trainer uploads for a split of ``rows`` rows whose
    neighbours come from ``pool_rows`` pool rows: int64 tokens, float32
    labels, int64 neighbour ids, the pool's tokens and labels."""
    return rows * (fields * 8 + 4 + topk * 8) + pool_rows * (fields * 8 + 4)


def _check_inter_block(paths, qry_block, cache, retrieval, device):
    """The inter-block neighbours of 512 queries of one block, read from
    its cache, against the plain scan over the concatenation of the other
    blocks with their union IDF (:func:`check_neighbours`, the cache's
    all-blocks ids mapped back to positions in that concatenation), and
    their rows, a dropped neighbour's being the last other block's last
    row."""
    arrays = [np.load(p) for p in paths]
    others = [a for j, a in enumerate(arrays) if j != qry_block]
    union = np.concatenate(others)
    own_start = sum(len(a) for a in arrays[:qry_block])
    own_end = own_start + len(arrays[qry_block])
    got = np.load(cache)
    idx = got["indices"]
    in_union = np.where(idx < 0, -1, np.where(idx >= own_end, idx - (own_end - own_start),
                                              idx))
    n_chk = check_neighbours(types.SimpleNamespace(
        retr_indices=in_union, retr_values=got["values"], retr_lens=got["lens"]),
        union, arrays[qry_block], retrieval, device, "blocks (b)")
    chk = in_union[:n_chk]
    want_rows = np.where((chk < 0)[..., None], others[-1][-1][None, None],
                         union[np.where(chk < 0, 0, chk)])
    if not np.array_equal(got["neighbor_rows"][:n_chk], want_rows):
        raise AssertionError("blocks (b): inter-block neighbour rows differ from the "
                             "other blocks' rows")
    return n_chk


def blocks(device, seed, work_dir, rows=MLTAG_SPLIT_ROWS, ids=MLTAG_IDS,
           block_rows=300_000, batch_size=None, timeout=600):
    """The published ML-Tag experiment with ``data_block_size`` set, as a
    user runs it from CSV (the cli phase's CSVs under ``work_dir/csv``,
    written here if absent), built into a data directory of its own, one
    epoch: (a) the reference's behaviour, 10-fold self-retrieval within
    each train block and the valid and test blocks retrieved against the
    first train block, block-mode training and evaluation; (b) the same
    build with ``inter_block_retrieval: true`` (each train block against
    all the others; the valid and test caches of (a) read) and
    ``profile_dir``. Checks: the launch counts from the block sizes, the
    neighbours of 512 queries of a train block in (a)'s cache and (b)'s
    against plain scans, the trainer's peak of split bytes on the device
    equal to one block's, the trace file, AUC above 0.5. ``batch_size``
    other than the config's is for runs on the CPU. Returns a dict of
    results."""
    cuda = torch.device(device).type == "cuda"
    gpu = (torch.device(device).index or 0) if cuda else -1
    csv_dir = os.path.join(work_dir, "csv")
    n_train, n_valid, n_test = rows
    if not os.path.exists(os.path.join(csv_dir, "test.csv")):
        make_mltag_like(csv_dir, n_train=n_train, n_valid=n_valid, n_test=n_test,
                        seed=seed, **ids)
    data_root = os.path.join(work_dir, "blocks_data")
    model_root = os.path.join(work_dir, "blocks_exps")
    profile_dir = os.path.join(work_dir, "blocks_profile")
    block_line = "data_block_size: {}".format(block_rows)
    config_a, config_b = (os.path.join(work_dir, name) for name in ("blocks_a", "blocks_b"))
    write_cli_config(config_a, data_root, model_root, csv_dir, 1, [block_line],
                     batch_size=batch_size)
    write_cli_config(config_b, data_root, model_root, csv_dir, 1,
                     [block_line, "profile_dir: '{}'".format(profile_dir),
                      "profile_steps: 10"], ["inter_block_retrieval: true"], batch_size)
    runs = [_run_cli(config, gpu, timeout) for config in (config_a, config_b)]
    dataset_id = MLTAG_EXPID.replace("RAT_m2_", "")
    data_dir = os.path.join(data_root, dataset_id)
    with open(os.path.join(model_root, dataset_id, MLTAG_EXPID + ".csv")) as fh:
        lines = fh.read().splitlines()
    if len(lines) != 2:
        raise AssertionError("blocks: {} results lines, expected 2".format(len(lines)))
    for line in lines:
        auc = float(re.search(r"AUC: ([0-9.]+)", _results_metrics(line)["val"]).group(1))
        if not auc > 0.5:
            raise AssertionError("blocks: valid AUC {} is not above 0.5".format(auc))

    retrieval = MLTAG_RETRIEVAL
    K, F = retrieval["topK"], len(retrieval["used_cols"])
    sizes = {split: _block_sizes(n, block_rows) for split, n in zip(
        ("train", "valid", "test"), rows)}
    paths = [os.path.join(data_dir, "train_part_{}.npy".format(i))
             for i in range(len(sizes["train"]))]
    if sorted(f for f in os.listdir(data_dir) if f.endswith(".npy")) != sorted(
            "{}_part_{}.npy".format(split, i) for split, b in sizes.items()
            for i in range(len(b))):
        raise AssertionError("blocks: the build wrote other blocks than {}".format(sizes))
    check_fold_cache(np.load(paths[1]), retrieval_cache_path(paths[1], K), retrieval,
                     device, "blocks (a)")
    inter = glob.glob(os.path.join(data_dir, "retrieval_inter_*_{}_train_part_1.npz"
                                   .format(K)))
    if len(inter) != 1:
        raise AssertionError("blocks (b): inter-block caches {}".format(inter))
    n_chk = _check_inter_block(paths, 1, inter[0], retrieval, device)

    depth, batch = MLTAG_PARAMS["depth"], batch_size or MLTAG_PARAMS["batch_size"]
    steps, valid_batches, test_batches = (sum(-(-b // batch) for b in sizes[split])
                                          for split in ("train", "valid", "test"))
    k1_run = depth * (steps + 2 * valid_batches + test_batches) if cuda else 0
    k2_a = sum(_fold_k2_batches(b, retrieval) for b in sizes["train"]) \
        + sum(_k2_batches(b, retrieval) for b in sizes["valid"] + sizes["test"])
    k2_b = sum(_k2_batches(b, retrieval) * (len(sizes["train"]) - 1) for b in sizes["train"])
    expected = [{"cross_intra_block": k1_run, "bm25_topk": k2_a if cuda else 0,
                 "bm25_score_chunk": 0},
                {"cross_intra_block": k1_run, "bm25_topk": k2_b if cuda else 0,
                 "bm25_score_chunk": 0}]
    launches = [r[1] for r in runs]
    if launches != expected:
        raise AssertionError("blocks: launches {} against the expected {}".format(
            launches, expected))
    # one block on the device at a time: a train block with its own
    # rows (a) or its neighbours' rows (b) as the pool, or a valid or
    # test block with the first train block as its pool
    big, first = max(sizes["train"]), sizes["train"][0]
    eval_block = max(_split_bytes(b, first, F, K) for b in sizes["valid"] + sizes["test"])
    one_block = [max(_split_bytes(big, big, F, K), eval_block),
                 max(_split_bytes(big, big * K, F, K), eval_block)]
    memory = [r[4] for r in runs]
    if [m["peak_split_bytes"] for m in memory] != one_block:
        raise AssertionError("blocks: peak split bytes {} against one block's {}".format(
            [m["peak_split_bytes"] for m in memory], one_block))
    traces = glob.glob(os.path.join(profile_dir, "trace_*.json"))
    if len(traces) != 1 or os.path.getsize(traces[0]) == 0:
        raise AssertionError("blocks (b): no profiler trace in {}".format(profile_dir))
    out = {"rows": list(rows), "block_rows": block_rows, "blocks": sizes,
           "results_lines": lines, "neighbours_checked": n_chk,
           "trace_bytes": os.path.getsize(traces[0])}
    for name, (stages, _, _, seconds, mem), one in zip(("a", "b"), runs, one_block):
        out[name] = {"command_s": seconds, "stage_s": stages,
                     "peak_split_bytes": mem["peak_split_bytes"],
                     "one_block_bytes": one,
                     "max_memory_allocated": mem["max_memory_allocated"]}
    return out, {"a": launches[0], "b": launches[1]}


def _exm_batches(db, qry, exact, batch, K):
    """(flat batches, scored batches, largest and mean matched window,
    seconds of the host's window search) of an exact-match call, by the
    branch rule of retrieval/bm25.py."""
    t0 = time.perf_counter()
    _, matched, _, lens = bm25._exm_group_windows(db, qry, exact)
    windows_s = time.perf_counter() - t0
    rest = db.shape[1] > len(exact)
    flat = scored = 0
    for lo in range(0, len(qry), batch):
        m = matched[lo:lo + batch]
        if m.any():
            if rest and lens[lo:lo + batch][m].max() > K:
                scored += 1
            else:
                flat += 1
    return flat, scored, int(lens.max()), float(lens[matched].mean()), windows_s


def exact_match(device, seed, pool, test, uniform_pool, uniform_test):
    """Exact-match retrieval (plain PyTorch on the device: no kernel)
    over the ML-Tag arrays, K=5, batches of 5000 requests: (1) user_id
    exact on the Zipf ids (heavy windows, scanned in 4096-row passes);
    (2) user_id exact on uniform ids (windows of about 80 rows); (3) all
    three columns exact (no other column: every batch flat, windows cut
    to their last K rows). Each call's first batch must equal, bit for
    bit, the same call on the CPU over those requests. Returns a dict of
    results."""
    retrieval = MLTAG_RETRIEVAL
    used, K, batch = retrieval["used_col_indices"], retrieval["topK"], \
        retrieval["qry_batch_size"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for name, db_rows, qry_rows, exact in (
            ("zipf_user_exact", pool, test, [0]),
            ("uniform_user_exact", uniform_pool, uniform_test, [0]),
            ("all_exact", pool, test, [0, 1, 2])):
        db = db_rows[:, used].astype(np.int64)
        qry = qry_rows[:, used].astype(np.int64)
        kw = dict(exact_match_col_indices=exact, qry_batch_size=batch, topK=K)
        sync()
        t0 = time.perf_counter()
        res = bm25.bm25_topk_retrieval(db, qry, device=device, **kw)
        sync()
        seconds = time.perf_counter() - t0
        first = bm25.bm25_topk_retrieval(db, qry[:batch], device="cpu", **kw)
        for a, b, what in zip(res, first, res._fields):
            if not np.array_equal(a[:batch], b):
                raise AssertionError("exact_match {}: the first batch's {} differ from "
                                     "the CPU's".format(name, what))
        if np.any((res.indices >= 0).sum(1) != res.lens):
            raise AssertionError("exact_match {}: lens do not count the neighbours"
                                 .format(name))
        hit = res.indices >= 0
        rows_q = np.repeat(np.arange(len(qry)), K).reshape(-1, K)[hit]
        if not np.array_equal(db[res.indices[hit]][:, exact], qry[rows_q][:, exact]):
            raise AssertionError("exact_match {}: a neighbour differs on an exact column"
                                 .format(name))
        flat, scored, longest, mean, windows_s = _exm_batches(db, qry, exact, batch, K)
        out[name] = {"requests": len(qry), "pool_rows": len(db), "exact_cols": exact,
                     "seconds": seconds, "requests_per_s": len(qry) / seconds,
                     "flat_batches": flat, "scored_batches": scored,
                     "largest_window": longest, "mean_window": mean,
                     "host_window_search_s": windows_s,
                     "mean_neighbours": float(res.lens.mean()),
                     "cpu_checked_requests": min(batch, len(qry))}
        print("exact_match {}: {}".format(name, json.dumps(out[name])))
    return out


# KKBox-shaped CSVs for the native phase: the port's make_kkbox_like
# (user, song, a '|'-separated genre sequence) at KKBox's vocabularies,
# with rows cut for chip time (the real split: 5,901,932 / 737,743 /
# 737,743 rows). The schema is the published config's for these columns
# (configs/RAT_m2/kkbox_x1/dataset_config.yaml): string ids, a genre
# sequence of 3 with MaskedSumPooling, min_categr_count 10.
NATIVE_ROWS = (500_000, 50_000, 50_000)


def native_dataset_params(csv_dir, data_root):
    return {
        "dataset_id": "kkbox_like_native", "data_root": data_root, "data_format": "csv",
        "feature_cols": [
            {"active": True, "dtype": "str", "name": ["msno", "song_id"],
             "type": "categorical"},
            {"active": True, "dtype": "str", "encoder": "MaskedSumPooling", "max_len": 3,
             "name": "genre_ids", "type": "sequence", "splitter": "|"}],
        "label_col": {"dtype": "float", "name": "label"}, "min_categr_count": 10,
        "train_data": os.path.join(csv_dir, "train.csv"),
        "valid_data": os.path.join(csv_dir, "valid.csv"),
        "test_data": os.path.join(csv_dir, "test.csv")}


def _build_kkbox_like(params):
    """Build the dataset in-process; returns (the build's stage seconds
    with its total, the encoders that ran)."""
    preprocess.reset_encoders_run()
    t0 = time.perf_counter()
    seconds = build_dataset(FeatureEncoder(**params), **params)
    seconds["total"] = time.perf_counter() - t0
    return seconds, preprocess.encoders_run()


def native(seed, work_dir, rows=NATIVE_ROWS, vocab=None, min_rows=None):
    """The native host encoder (rat_tpu_torch/native): whether the
    interpreter's Python.h is there, the extension's build, then one
    KKBox-shaped dataset built twice from the same CSVs, with the
    extension (columns of ``min_rows`` rows or more, the package's
    threshold by default) and with the Python encoders (the threshold
    raised in-process). feature_map.json must be byte-identical and every
    split array-equal. No kernel runs here. Returns a dict of results."""
    header = native_ext.python_header()
    print("native: Python.h {} at {}".format(
        "present" if os.path.exists(header) else "MISSING", header))
    if not os.path.exists(header):
        print("native: no Python.h at {}: the extension cannot build; the Python "
              "encoders run".format(header))
        return {"python_h": False, "header": header}
    t0 = time.perf_counter()
    if not native_ext.build():
        raise AssertionError("native: Python.h is there but the extension did not build")
    build_s = time.perf_counter() - t0
    vocab = vocab or {"n_users": KKBOX_VOCAB["msno"], "n_songs": KKBOX_VOCAB["song_id"],
                      "n_genres": KKBOX_VOCAB["genre_ids"]}
    csv_dir = os.path.join(work_dir, "kkbox_csv")
    t0 = time.perf_counter()
    make_kkbox_like(csv_dir, n_train=rows[0], n_valid=rows[1], n_test=rows[2],
                    seed=seed, **vocab)
    csv_s = time.perf_counter() - t0
    default_min = preprocess._NATIVE_MIN_ROWS
    runs = {}
    try:
        for name, threshold in (("native", default_min if min_rows is None else min_rows),
                                ("python", 10 ** 12)):
            preprocess._NATIVE_MIN_ROWS = threshold
            params = native_dataset_params(csv_dir, os.path.join(work_dir, name))
            runs[name] = _build_kkbox_like(params)
    finally:
        preprocess._NATIVE_MIN_ROWS = default_min
    expected = {"native": {"category": "native", "count_tokens": "native",
                           "sequence": "native"},
                "python": {"category": "python", "count_tokens": "python",
                           "sequence": "python"}}
    for name, (_, ran) in runs.items():
        if ran != expected[name]:
            raise AssertionError("native: the {} build ran the encoders {}".format(name, ran))
    dirs = [os.path.join(work_dir, name, "kkbox_like_native") for name in runs]
    with open(os.path.join(dirs[0], "feature_map.json"), "rb") as fa, \
            open(os.path.join(dirs[1], "feature_map.json"), "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("native: feature_map.json differs between the builds")
    for split in ("train", "valid", "test"):
        a, b = (np.load(os.path.join(d, split + ".npy")) for d in dirs)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("native: the {} split differs between the builds".format(
                split))
    return {"python_h": True, "header": header, "extension_build_s": build_s,
            "rows": list(rows), "csv_write_s": csv_s,
            "native_build_s": runs["native"][0], "python_build_s": runs["python"][0],
            "feature_map_identical": True, "splits_equal": True}


# the train benches' steps in this script, cut for chip time (the
# defaults, which bench_torch.py's headline runs: 64 warm-up steps and
# windows of 512; bench_torch.py's KKBox and Tmall lines: windows of 256)
def _repo_env(**extra):
    """This process's environment with ``extra`` and the repo first on
    PYTHONPATH, for a subprocess that imports the port."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]), **extra)


BENCH_STEPS = {"mltag": {"warmup": 64, "steps": 64}, "kkbox": {"warmup": 8, "steps": 8},
               "tmall": {"warmup": 8, "steps": 8}}


def bench_train_steps(warmup, steps, group=64):
    """(warm-up steps, steps per window) that benchmark.bench_train runs:
    groups of min(group, steps), at least one of warm-up."""
    group = min(group, steps)
    if group <= 1:
        return warmup, steps
    return max(1, warmup // group) * group, steps // group * group


def bench(device, batch_size=4096, n_rows=200_000, steps=BENCH_STEPS, eval_steps=100,
          retrieval_rows=(200_000, 100_000)):
    """The port's benchmark suite in-process (rat_tpu_torch.cli.benchmark)
    at ``steps`` (warm-up, window) per shape: train on ML-Tag plain and
    fused, on KKBox and on Tmall, eval on ML-Tag, BM25 retrieval and
    exact-match retrieval, each bench's launches asserted from the code;
    then, on a card, ``bench_torch.py`` (the headline with its health
    stamp, fused path) and ``python -m rat_tpu_torch.ops.bench_kernel``
    as subprocesses. The retrieval bench's pool and queries are then
    retrieved once more with every K2 call held to its plain version.
    Returns (the lines, the launches of the in-process benches, the K2
    calls compared by their query count)."""
    cuda = torch.device(device).type == "cuda"
    depth = benchmark.SHAPES["mltag"]["model"]["depth"]
    n_db, n_qry = retrieval_rows
    def train(use_pallas, shape):
        return lambda: benchmark.bench_train(use_pallas, shape=shape, batch_size=batch_size,
                                             n_rows=n_rows, device=device, **steps[shape])

    warm, window = bench_train_steps(**steps["mltag"])
    fused_k1 = depth * (warm + 3 * window)
    # (name, bench, K1 launches, K2 launches) on a card: K1 only on the
    # fused ML-Tag path (the KKBox and Tmall shapes have BatchNorm, which
    # closes the fused gate, and the eval bench runs the module path, as
    # in the JAX package); K2 once per 2048-query batch in each of the
    # retrieval bench's two calls; exact match scans in plain PyTorch
    runs = [("train mltag", train(False, "mltag"), 0, 0),
            ("train_pallas mltag", train(True, "mltag"), fused_k1, 0),
            ("train kkbox", train(False, "kkbox"), 0, 0),
            ("train tmall", train(False, "tmall"), 0, 0),
            ("eval mltag", lambda: benchmark.bench_eval(
                eval_steps, "mltag", batch_size, n_rows, device), 0, 0),
            ("retrieval", lambda: benchmark.bench_retrieval(n_db, n_qry, device=device),
             0, 2 * -(-n_qry // 2048)),
            ("retrieval_exm", lambda: benchmark.bench_retrieval_exm(
                n_db, n_qry, device=device), 0, 0)]
    lines, launches = {}, {"cross_intra_block": 0, "bm25_topk": 0, "bm25_score_chunk": 0}
    for name, fn, want_k1, want_k2 in runs:
        k1.launches = k2.launches = k3.launches = 0
        t0 = time.perf_counter()
        line = fn()
        got = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
               "bm25_score_chunk": k3.launches}
        want = {"cross_intra_block": want_k1 if cuda else 0,
                "bm25_topk": want_k2 if cuda else 0, "bm25_score_chunk": 0}
        if got != want:
            raise AssertionError("bench {}: launches {} against {}".format(name, got, want))
        line["seconds"] = time.perf_counter() - t0
        lines[name] = line
        launches = {k: launches[k] + got[k] for k in launches}
        print("bench {}: {}".format(name, json.dumps(line)))
    # the retrieval bench's own pool and queries once more, every K2 call
    # (2048-query batches and the tail) held to the plain scan
    db, q = benchmark.retrieval_arrays(n_db, n_qry)
    with k2_held_to_plain("bench retrieval") as compared:
        bm25.bm25_topk_retrieval(db, q, topK=5, device=device, **benchmark.RETRIEVAL_KW)
    print("bench retrieval: K2 equal to its plain version in every call, {} pool rows, "
          "calls by queries {}".format(n_db, json.dumps(compared)))
    if not cuda:
        return lines, launches, compared
    env = _repo_env(RAT_TPU_BENCH_HEADLINE_ONLY="1", RAT_TPU_BENCH_PALLAS="1")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError("bench_torch.py exited {}:\n{}".format(out.returncode,
                                                                   out.stderr[-3000:]))
    headline = json.loads([l for l in out.stdout.splitlines() if l.startswith("{")][-1])
    health = headline["chip_health"]
    if "error" in health or not health.get("probe_valid"):
        raise AssertionError("bench_torch.py: the health stamp failed: {}".format(health))
    if health.get("matmul_tf32") is not False and "RAT_TPU_MATMUL_PRECISION" not in env:
        raise AssertionError("bench_torch.py: TF32 on at the default matmul precision: "
                             "{}".format(health))
    headline["command_s"] = time.perf_counter() - t0
    lines["bench_torch.py headline"] = headline
    print("bench bench_torch.py headline (fused path, default steps): "
          + json.dumps(headline))
    out = subprocess.run([sys.executable, "-m", "rat_tpu_torch.ops.bench_kernel"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError("bench_kernel exited {}:\n{}".format(out.returncode,
                                                                 out.stderr[-3000:]))
    print("bench bench_kernel: " + " | ".join(out.stdout.strip().splitlines()))
    m = re.search(r"max diff: (\S+) \(largest \|output\| (\S+)\)", out.stdout)
    diff, largest = float(m.group(1)), float(m.group(2))
    if not diff <= 1e-5 + 1e-4 * largest:
        raise AssertionError("bench_kernel: K1 differs from the plain block by {}".format(
            diff))
    lines["bench_kernel"] = out.stdout.strip().splitlines()
    return lines, launches, compared


def autotune_kernel_checks(params, device, seed):
    """K1 and K2 at the sweep runs' shapes, each held to its plain
    version, on the sweep's built dataset: K2 through the retrieval
    engine as the runs call it (fold 0 of the X-fold self-retrieval, the
    valid and test splits against the train pool), K1 at the batch size
    on random inputs and weights, whole and as the last train and valid
    batches pad it (rtol 1e-4 / atol 1e-5). Returns what was compared."""
    data_dir = os.path.join(params["data_root"], params["dataset_id"])
    with open(os.path.join(data_dir, "feature_map.json")) as fh:
        specs = json.load(fh)["feature_specs"]
    rc = params["retrieval_configs"]
    used = [specs[c]["index"] for c in rc["used_cols"]]
    splits = {name: np.load(os.path.join(data_dir, name + ".npy"))[:, used].astype(np.int64)
              for name in ("train", "valid", "test")}
    train, fold = splits["train"], _fold_size(len(splits["train"]), rc)
    kw = dict(qry_batch_size=rc["qry_batch_size"], db_chunk_size=rc["db_chunk_size"],
              topK=rc["topK"], device=device)
    with k2_held_to_plain("autotune") as compared:
        bm25.bm25_topk_retrieval(train[fold:], train[:fold], **kw)
        for name in ("valid", "test"):
            bm25.bm25_topk_retrieval(train, splits[name], **kw)
    B, d = params["batch_size"], params["embedding_dim"]
    rng = np.random.RandomState(seed)
    k1_err = {}
    for name, valid in (("whole", None), ("last train", len(train) % B or None),
                        ("last valid", len(splits["valid"]) % B or None)):
        ok, err, *_ = _k1_case(rng, device, B, 1 + rc["topK"], len(specs) + 1, d,
                               params["num_heads"], params["dim_head"],
                               hidden=params["scale_dim"] * d, valid=valid)
        if not ok:
            raise AssertionError("autotune: K1 differs from its plain version at B={} "
                                 "({} batch)".format(B, name))
        k1_err["{} ({} real rows)".format(name, valid or B)] = err.max().item()
    return {"k2_pool_rows": [len(train) - fold, len(train)],
            "k2_calls_by_queries": compared, "k1_batch": B, "k1_max_abs_err": k1_err}


def autotune(device, seed, work_dir, rows=(8000, 2000, 2000), epochs=2):
    """A sweep as a user runs one (rat_tpu_torch.autotuner): a tuner file
    over the demo experiment (configs/demo, RAT_m2 at d=10, depth 2, with
    ``use_pallas: true``) on make_mltag_like CSVs, ``learning_rate: [1e-3,
    1e-4]``, enumerated into two expids and run by ``grid_search`` over
    the slots [this card, {"RAT_TPU_PLATFORM": "cpu"}] (on the CPU: [-1,
    the same]) at once. The dataset is built once beforehand, so that the
    two runs only read it, and K1 and K2 are first held to their plain
    versions at the runs' shapes. Checks: exit code 0 and one results
    line for each expid, kernel launches in the card run's log. Returns
    (results, the card run's launches)."""
    cuda = torch.device(device).type == "cuda"
    csv_dir = os.path.join(work_dir, "csv")
    make_mltag_like(csv_dir, n_train=rows[0], n_valid=rows[1], n_test=rows[2], seed=seed)
    demo = os.path.join(REPO, "configs", "demo")
    expid = "RAT_m2_demo_10fold_retrieval"
    with open(os.path.join(demo, "model_config.yaml")) as fh:
        models = safe_load(fh)
    with open(os.path.join(demo, "dataset_config.yaml")) as fh:
        dataset = safe_load(fh)["demo_10fold_retrieval"]
    dataset.update(data_root=os.path.join(work_dir, "data") + "/",
                   **{s + "_data": os.path.join(csv_dir, s + ".csv")
                      for s in ("train", "valid", "test")})
    tuner = {"base_expid": expid,
             "model_config": {
                 "Base": dict(models["Base"], model_root=os.path.join(work_dir, "exps") + "/"),
                 expid: dict(models[expid], epochs=epochs, use_pallas=True)},
             "dataset_config": {"demo_10fold_retrieval": dataset},
             "tuner_space": {"learning_rate": [1e-3, 1e-4]}}
    tuner_file = os.path.join(work_dir, "sweep.yaml")
    with open(tuner_file, "w") as fh:
        fh.write(yaml_dump(tuner))
    config_dir = autotuner.enumerate_params(tuner_file)
    expids = autotuner.load_experiment_ids(config_dir)
    params = load_config(config_dir, expids[0])
    build_dataset(FeatureEncoder(**params), **params)
    checks = autotune_kernel_checks(params, device, seed)
    print("autotune: K1 and K2 equal to their plain versions at the runs' shapes: "
          + json.dumps(checks))

    gpu = (torch.device(device).index or 0) if cuda else -1
    slots = [gpu, {"RAT_TPU_PLATFORM": "cpu", "OMP_NUM_THREADS": "2"}]
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [saved] if p])
    t0 = time.perf_counter()
    try:
        rcs = autotuner.grid_search("torch", config_dir, slots)
    finally:
        if saved is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = saved
    seconds = time.perf_counter() - t0
    out = {"expids": expids, "slots": [str(s) for s in slots], "exit_codes": rcs,
           "sweep_s": seconds, "results": {}, "launches": {}, "kernel_checks": checks}
    if any(rcs.values()):
        raise AssertionError("autotune: runs exited {}".format(rcs))
    model_dir = os.path.join(work_dir, "exps", params["dataset_id"])
    for run in expids:
        with open(os.path.join(model_dir, run + ".csv")) as fh:
            lines = fh.read().splitlines()
        if len(lines) != 1 or "[exp_id] {},".format(run) not in lines[0]:
            raise AssertionError("autotune: results of {}: {}".format(run, lines))
        with open(os.path.join(model_dir, run + ".log")) as fh:
            found = [l for l in fh.read().splitlines() if "Kernel launches: " in l]
        out["results"][run] = _results_metrics(lines[0])
        out["launches"][run] = json.loads(found[-1].split("Kernel launches: ", 1)[1])
    card = out["launches"][expids[0]]
    if cuda and not card["cross_intra_block"] > 0:
        raise AssertionError("autotune: the card run launched no K1: {}".format(card))
    if any(out["launches"][expids[1]].values()) or (not cuda and any(card.values())):
        raise AssertionError("autotune: a CPU run counted launches {}".format(
            out["launches"]))
    return out, card


# the precision phase: the JAX package's reduced-precision gate
# (tests/test_bf16_gate.py) at its shape and bounds, on the card: the same
# RAT_m2 fit at a KKBox-like shape (d=40, 8 heads, BatchNorm, the wide
# tower; 8,192 / 2,048 rows, 2-fold self-retrieval, topK 3, 4 epochs) at
# float32 and at bfloat16, which the port runs as TF32
GATE_AUC = 0.005
GATE_LOGLOSS = 0.01
GATE_K = 3
GATE_VOCABS = {"user_id": 300, "item_id": 200, "tag_id": 50}
GATE_ROWS = (8192, 2048)
GATE_RETRIEVAL = {"used_col_indices": [0, 1, 2], "exact_match_col_indices": None,
                  "split_type": "2-fold", "label_wise": False, "pre_retrieval": True,
                  "topK": GATE_K, "qry_batch_size": 2048, "db_chunk_size": 4096}
GATE_PARAMS = dict(model="RAT_m2", batch_size=1024, learning_rate=1e-3, epochs=4,
                   embedding_dim=40, dnn_hidden_units=[64, 32], dnn_activations="relu",
                   num_heads=8, dim_head=10, depth=2, scale_dim=4, dropout=0.0,
                   emb_dropout=0.0, net_dropout=0.0, batch_norm=True, use_wide=True,
                   embedding_regularizer="l2(1.e-5)", net_regularizer=0,
                   metrics=["AUC", "logloss"], monitor="AUC", monitor_mode="max",
                   patience=4, every_x_epochs=1, save_best_only=True,
                   reduce_lr_on_plateau=True, shuffle=False, verbose=0, seed=5,
                   loss="binary_crossentropy", optimizer="adam",
                   task="binary_classification")
# settings of the bench steps' timing windows, in turns
PRECISION_TURNS = ("float32", "bfloat16")


def gate_rows(n, rng):
    """[user_id, item_id, tag_id, label] float64 rows, drawn as
    tests/test_bf16_gate.py's ``_synth_rows`` draws them."""
    u = rng.randint(0, GATE_VOCABS["user_id"], n)
    i = rng.randint(0, GATE_VOCABS["item_id"], n)
    t = rng.randint(0, GATE_VOCABS["tag_id"], n)
    logit = 1.1 * (u % 3 == 0) + 0.8 * (i % 2 == 0) + 0.5 * (t % 4 == 0) - 1.2
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-2.5 * logit))).astype(np.float64)
    return np.stack([u, i, t, y], axis=1).astype(np.float64)


def gate_fit(device, work_dir, tag, rows=GATE_ROWS, epochs=4):
    """One fit of the gate under ``work_dir/tag``, as the JAX test runs
    it: the splits from RandomState(11) written as .npy, the train split
    retrieving from itself in 2 folds and the valid split from the train
    file, Trainer.fit for ``epochs`` without shuffling, then evaluate on
    the valid split. Returns (metrics, valid predictions, {split: its
    neighbour cache})."""
    rng = np.random.RandomState(11)
    paths = {split: os.path.join(work_dir, tag, split + ".npy") for split in ("train", "valid")}
    os.makedirs(os.path.join(work_dir, tag))
    for split, n in zip(paths, rows):
        np.save(paths[split], gate_rows(n, rng))
    fm = FeatureMap("bf16_" + tag, ".")
    fm.feature_specs.update(
        {name: {"source": "", "type": "categorical", "vocab_size": v, "index": idx}
         for idx, (name, v) in enumerate(GATE_VOCABS.items())})
    fm.num_fields = fm.input_length = len(GATE_VOCABS)
    fm.num_features = sum(GATE_VOCABS.values())
    common = dict(batch_size=GATE_PARAMS["batch_size"], shuffle=False, feature_map=fm,
                  retrieval_configs=dict(GATE_RETRIEVAL), retrieval_augmented=True,
                  device=device)
    train_gen = DataGenerator(data_path=paths["train"], retrieval_pool_fname="self",
                              **common)
    valid_gen = DataGenerator(data_path=paths["valid"], retrieval_pool_fname=paths["train"],
                              **common)
    trainer = Trainer(fm, dict(GATE_PARAMS, model_id="RAT_m2_bf16_" + tag,
                               model_root=os.path.join(work_dir, "exps_" + tag)),
                      device=device)
    trainer.fit(train_gen, valid_gen, epochs=epochs)
    logs = trainer.evaluate(valid_gen, data=trainer._valid_data)
    preds = trainer.predict(valid_gen, data=trainer._valid_data)
    caches = {split: load_arrays(retrieval_cache_path(path, GATE_K))
              for split, path in paths.items()}
    return logs, preds, caches


def _matmul_err(device, n=1024):
    """Largest |error| of an n x n float32 product on ``device`` against
    the same product in float64."""
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(n, n, generator=gen) for _ in range(2))
    got = (a.to(device) @ b.to(device)).cpu().double()
    return float((got - a.double() @ b.double()).abs().max())


def _step_device_ms(trainer, data, idx, batch, steps, warmup):
    """Device ms per train step (torch.profiler's kernels and copies)
    over ``steps`` steps after ``warmup``; the steps run on the CPU too,
    where no time is read (None)."""
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        for i in range(n):
            trainer.train_step(data, idx[i % len(idx)], batch)
    run(warmup)
    if trainer.device.type != "cuda":
        run(steps)
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _device_events(prof.key_averages())) \
        / 1e3 / steps


def _stamp_under(value):
    """The health stamp (``python -m rat_tpu_torch.cli.chip_health``) of a
    process started with RAT_TPU_MATMUL_PRECISION=``value``."""
    out = subprocess.run([sys.executable, "-m", "rat_tpu_torch.cli.chip_health"], cwd=REPO,
                         env=_repo_env(RAT_TPU_MATMUL_PRECISION=value),
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError("chip_health exited {}:\n{}".format(out.returncode,
                                                                out.stderr[-3000:]))
    return json.loads(out.stdout.strip().splitlines()[-1])


def precision(device, work_dir, rows=GATE_ROWS, epochs=4, bench_shapes=("tmall", "kkbox"),
              bench_batch=4096, bench_rows=200_000, steps=20, warmup=3):
    """The reduced-precision gate: ``gate_fit`` at float32, then at
    bfloat16 (TF32) set through ``rat_tpu_torch.set_matmul_precision``;
    float32 is restored in a ``finally``. Then the bench's train steps
    at ``bench_shapes`` (cli/benchmark.py's setup, ``bench_batch`` and
    ``bench_rows``) timed in ``steps``-step windows at the settings of
    PRECISION_TURNS. Checks: at each setting the matmul TF32 switch reads
    the setting and cuDNN's TF32 is off; after the phase, float32 again;
    every K2 call of the fits equals K2's plain version; the two fits'
    neighbour caches are identical; the launches (K2 = 2 x the query
    batches of the 2 folds and the valid split, K1 = K3 = 0). On a card
    also: the
    gate's |dAUC| < GATE_AUC and |dlogloss| < GATE_LOGLOSS; the check is
    not vacuous: a 1024 x 1024 product's error against float64 at
    bfloat16 is at least 10x the error at float32, and the two fits'
    valid predictions differ; the health stamp of a process started with
    RAT_TPU_MATMUL_PRECISION=bfloat16 reads TF32 on. Returns a dict of
    results."""
    cuda = torch.device(device).type == "cuda"
    out = {"rows": list(rows), "epochs": epochs, "tf32": {},
           "matmul_1024_max_abs_err": {}, "fits": {},
           "step_device_ms": {shape: {} for shape in bench_shapes}, "seconds": {}}
    fits = {}
    k1.launches = k2.launches = k3.launches = 0
    try:
        with k2_held_to_plain("precision") as compared:
            for name in ("float32", "bfloat16"):
                rat_tpu_torch.set_matmul_precision(name)
                out["tf32"][name] = bool(torch.backends.cuda.matmul.allow_tf32)
                if out["tf32"][name] != (name != "float32") \
                        or torch.backends.cudnn.allow_tf32:
                    raise AssertionError("precision: at {} matmul TF32 reads {}, cuDNN {}"
                                         .format(name, out["tf32"][name],
                                                 torch.backends.cudnn.allow_tf32))
                out["matmul_1024_max_abs_err"][name] = _matmul_err(device)
                t1 = time.perf_counter()
                fits[name] = gate_fit(device, work_dir, name, rows, epochs)
                out["seconds"]["fit_" + name] = time.perf_counter() - t1
                out["fits"][name] = {k: fits[name][0][k] for k in ("AUC", "logloss")}
        launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
                    "bm25_score_chunk": k3.launches}
        for shape in out["step_device_ms"]:
            t1 = time.perf_counter()
            trainer, data, idx, batch = benchmark._bench_setup(shape, False, bench_batch,
                                                               n_rows=bench_rows,
                                                               device=device)
            for name in PRECISION_TURNS:
                rat_tpu_torch.set_matmul_precision(name)
                out["step_device_ms"][shape].setdefault(name, []).append(
                    _step_device_ms(trainer, data, idx, batch, steps, warmup))
            del trainer, data, idx
            if cuda:
                torch.cuda.empty_cache()
            out["seconds"][shape + "_steps"] = time.perf_counter() - t1
    finally:
        rat_tpu_torch.set_matmul_precision("float32")
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("precision: float32 was not restored")
    after = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
             "bm25_score_chunk": k3.launches}
    if after != launches:
        raise AssertionError("precision: the bench steps launched kernels: {} after the "
                             "fits' {}".format(after, launches))

    (f32, p32, c32), (bf16, p16, c16) = fits["float32"], fits["bfloat16"]
    for split in c32:
        if sorted(c32[split]) != sorted(c16[split]) or not all(
                np.array_equal(c32[split][k], c16[split][k]) for k in c32[split]):
            raise AssertionError("precision: the {} neighbour caches differ".format(split))
    if not (np.all(np.isfinite(p32)) and np.all(np.isfinite(p16))
            and p32.shape == p16.shape == (rows[1],)):
        raise AssertionError("precision: predictions of shapes {} and {}, finite: {}"
                             .format(p32.shape, p16.shape, bool(np.all(np.isfinite(
                                 np.concatenate([p32, p16]))))))
    out["d_AUC"] = abs(f32["AUC"] - bf16["AUC"])
    out["d_logloss"] = abs(f32["logloss"] - bf16["logloss"])
    out["predictions_max_abs_diff"] = float(np.abs(p32 - p16).max())
    out["caches_identical"] = sorted(c32)
    out["cache_rows"] = {split: len(c32[split]["indices"]) for split in c32}
    calls = 2 * (_fold_k2_batches(rows[0], GATE_RETRIEVAL)
                 + _k2_batches(rows[1], GATE_RETRIEVAL))
    expected = {"cross_intra_block": 0, "bm25_topk": calls if cuda else 0,
                "bm25_score_chunk": 0}
    if launches != expected:
        raise AssertionError("precision: launches {} against the expected {}".format(
            launches, expected))
    if sum(compared.values()) != calls:
        raise AssertionError("precision: K2 held to its plain version in {} calls, not "
                             "{}".format(compared, calls))
    out["k2_held_to_plain"] = compared
    if cuda:
        err = out["matmul_1024_max_abs_err"]
        if not err["bfloat16"] >= 10 * err["float32"]:
            raise AssertionError("precision: the reduced setting did not reach the "
                                 "products: errors {}".format(err))
        if np.array_equal(p32, p16):
            raise AssertionError("precision: the two fits' valid predictions are "
                                 "bit-identical")
        if not (out["d_AUC"] < GATE_AUC and out["d_logloss"] < GATE_LOGLOSS):
            raise AssertionError("precision: the gate failed: float32 {}, bfloat16 {}"
                                 .format(f32, bf16))
        t1 = time.perf_counter()
        stamp = _stamp_under("bfloat16")
        out["seconds"]["stamp_under_bfloat16"] = time.perf_counter() - t1
        if "error" in stamp or stamp.get("matmul_tf32") is not True:
            raise AssertionError("precision: the stamp under RAT_TPU_MATMUL_PRECISION="
                                 "bfloat16: {}".format(stamp))
        out["stamp_under_bfloat16"] = {k: stamp.get(k) for k in (
            "matmul_tf32", "matmul_tflops", "mhsa_us", "probe_valid", "nvidia_smi")}
    return dict(out, launches=launches)


# the nnlib phase: the NN library off the main path at the KKBox
# config's widths (13 fields, d=40, batch 4096, DNN 400^3, 1+K = 6
# rows), each layer's card run held to its CPU run
NNLIB_OUT_TOL = {"rtol": 1e-4, "atol": 1e-5}
NNLIB_GRAD_TOL = {"rtol": 2e-3, "atol": 1e-4}
# trained-scale embeddings for the towers (the init's N(0, 1e-4) would
# make every product fall under the absolute tolerance)
NNLIB_EMB_STD = 0.1


class _PETGraph(torch.nn.Module):
    """PET over a batch of instance graphs: feature nodes take their
    MergedEmbeddingLayer rows (globally offset ids), instance nodes the
    label embedding (2 = [MASK] for the target), each edge the embedding
    of its cell's column; then PET_Layer."""

    def __init__(self, fm, n_cols, d, layers, generator):
        super().__init__()
        from rat_tpu_torch.nn import MergedEmbeddingLayer, PET_Layer
        self.merged = MergedEmbeddingLayer(fm, d, generator)
        self.label = torch.nn.Parameter(torch.randn((3, d), generator=generator))
        self.column = torch.nn.Parameter(0.1 * torch.randn((n_cols, d), generator=generator))
        self.pet = PET_Layer(layers, d, d, dropout=0.0, generator=generator)

    def forward(self, node_ids, labels, is_feature, edge_col, src, dst):
        feat = self.merged(torch.where(is_feature, node_ids, torch.zeros_like(node_ids)))
        # F.embedding: ~10^5 lookups of each of 3 labels and 17 columns
        node_h = torch.where(is_feature[:, None], feat,
                             torch.nn.functional.embedding(labels, self.label))
        return self.pet(node_h, torch.nn.functional.embedding(edge_col, self.column), src,
                        dst)


def _leaves(out):
    if isinstance(out, dict):
        return list(out.values())
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _worst(got, want, tol):
    """(max |got - want|, max of |got - want| / (atol + rtol |want|)): the
    check passes while the second is at most 1."""
    diff = (got.detach().double().cpu() - want.detach().double()).abs()
    return float(diff.max()), float((diff / (tol["atol"] + tol["rtol"]
                                             * want.detach().double().abs())).max())


def _run_layer(mod, xs, rs, kw):
    """Forward, then backward of sum(output * R); float inputs require
    their gradient. Returns (outputs, {parameter or input: gradient})."""
    xs = [x.detach().clone().requires_grad_() if x.is_floating_point() else x for x in xs]
    mod.zero_grad(set_to_none=True)
    outs = _leaves(mod(*xs, **kw))
    if rs is None:
        gen = torch.Generator().manual_seed(0)
        rs = [torch.randn(o.shape, generator=gen, dtype=o.dtype) for o in outs]
    sum((o * r).sum() for o, r in zip(outs, rs)).backward()
    grads = {name: p.grad for name, p in mod.named_parameters()}
    grads.update(("input{}".format(i), x.grad) for i, x in enumerate(xs)
                 if x.is_floating_point())
    return outs, grads, rs


def _errors(got_out, want_out, got_grad, want_grad):
    """The largest |error| of the outputs and of the gradients, the
    largest ratio of an error to NNLIB_OUT_TOL / NNLIB_GRAD_TOL (at most
    1 passes) and the gradient where it is, and the count of gradient
    elements beyond the tolerance."""
    res = {"out_max": max(float(o.detach().abs().max()) for o in want_out),
           "out_err": 0.0, "out_worst": 0.0, "grad_err": 0.0, "grad_worst": 0.0,
           "grad_worst_at": None, "grad_beyond": 0, "grad_elems": 0}
    for got, want in zip(got_out, want_out):
        err, worst = _worst(got, want, NNLIB_OUT_TOL)
        res.update(out_err=max(res["out_err"], err), out_worst=max(res["out_worst"], worst))
    for name, want in want_grad.items():
        got = got_grad[name]
        if (got is None) != (want is None):
            raise AssertionError("{}: a gradient on one device only".format(name))
        if want is None:
            continue
        err, worst = _worst(got, want, NNLIB_GRAD_TOL)
        res["grad_err"] = max(res["grad_err"], err)
        if worst >= res["grad_worst"]:
            res.update(grad_worst=worst, grad_worst_at=name)
        diff = (got.detach().double().cpu() - want.double()).abs()
        res["grad_beyond"] += int((diff > NNLIB_GRAD_TOL["atol"] + NNLIB_GRAD_TOL["rtol"]
                                   * want.double().abs()).sum())
        res["grad_elems"] += want.numel()
    return res


def _held(res):
    return res["out_worst"] <= 1 and res["grad_worst"] <= 1


def _hold_layer(module, inputs, device, kw=None, reps=3):
    """``module`` (built on the CPU) and a copy on ``device`` run forward
    and backward of sum(output * R), R ~ N(0, 1), on the same inputs:
    the outputs held within NNLIB_OUT_TOL, the parameter and input
    gradients within NNLIB_GRAD_TOL (_errors). A relu whose input lies
    within the two devices' float32 rounding of 0 takes the other branch
    on one of them and moves whole rows of the gradients before it, and
    a layer that amplifies its input's rounding (APG's weights generated
    from its own input) moves its small outputs past the absolute
    tolerance; where float32 misses, both runs are made again in float64
    and held to the same tolerances there (``float64``). Then ms per
    forward+backward (CUDA events) and the peak of max_memory_allocated
    in the first card run."""
    import copy
    kw = kw or {}
    cuda = torch.device(device).type == "cuda"
    pristine = copy.deepcopy(module)
    card = copy.deepcopy(module).to(device)
    want_out, want_grad, rs = _run_layer(module, inputs, None, kw)
    xs, rs = [x.to(device) for x in inputs], [r.to(device) for r in rs]
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    got_out, got_grad, _ = _run_layer(card, xs, rs, kw)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    res = _errors(got_out, want_out, got_grad, want_grad)
    res["ms"] = _cuda_ms(lambda: _run_layer(card, xs, rs, kw), reps) if cuda else None
    res["peak_mib"] = peak / 2 ** 20 if cuda else None
    if not _held(res):
        del card, got_out, got_grad, xs
        cpu64 = pristine.double()
        card64 = copy.deepcopy(cpu64).to(device)
        x64 = [x.double() if x.is_floating_point() else x for x in inputs]
        r64 = [r.double() for r in rs]
        want_out, want_grad, _ = _run_layer(cpu64, x64, [r.cpu() for r in r64], kw)
        got_out, got_grad, _ = _run_layer(card64, [x.to(device) for x in x64], r64, kw)
        res["float64"] = _errors(got_out, want_out, got_grad, want_grad)
    return res


def nnlib(device, seed, batch_size=4096, vocab=None):
    """Every layer of the NN library off the main path, forward and
    backward on ``device`` at the KKBox config's widths (13 fields,
    d=40, DNN 400^3; ``batch_size`` groups of 1+K = 6 rows of the KKBox
    map's 17 id columns, from kkbox_arrays), each held to the same
    module's run on the CPU (NNLIB_OUT_TOL on outputs, NNLIB_GRAD_TOL on
    gradients), timed and its peak memory read. Families: the v2 feature
    embeddings, the interactions over the target row's [B, 13, 40]
    embeddings, the tower layers, target attention over the 5
    neighbours, APG, and the graphs. Returns {family: {layer: result}}.
    Weights come from generators seeded with ``seed``."""
    from rat_tpu_torch import nn as lib
    from rat_tpu_torch.data.graph import PETGraphProcessor, batch_graphs

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("nnlib: TF32 is on; rat_tpu_torch's default (float32) "
                             "turns it off")
    gen = torch.Generator().manual_seed(seed)
    rows, _ = kkbox_arrays(seed, batch_size * 6, 0, vocab)
    grid = rows.reshape(batch_size, 6, -1)
    X = torch.from_numpy(grid[..., :-1].astype(np.int64))            # [B, 6, 17]
    fm = kkbox_feature_map(vocab)
    F_, d, B = len(fm.feature_specs), KKBOX_PARAMS["embedding_dim"], batch_size
    n_cols = X.shape[-1]
    std = "partial(nn.init.normal_, std={})".format(NNLIB_EMB_STD)
    out = {}

    def hold(family, name, module, inputs, **kw):
        out.setdefault(family, {})[name] = _hold_layer(module, inputs, device, **kw)

    def with_specs(changes):
        new = FeatureMap(fm.dataset_id, ".")
        new.feature_specs.update({name: dict(spec, **changes.get(name, {}))
                                  for name, spec in fm.feature_specs.items()})
        return new

    # the v2 embeddings: a dict with a KMax + Linear chain, a masked
    # average and a field at its own width; the tensor view of the map
    # with both sequences averaged feeds the towers
    avg = "layers.MaskedAveragePooling()"
    seq_a, seq_b = KKBOX_SEQUENCES
    fm_dict = with_specs({seq_a: {"feature_encoder": ["layers.KMaxPooling(2, dim=1)",
                                                      "nn.Linear({0}, {0})".format(d)]},
                          seq_b: {"feature_encoder": avg}, "isrc": {"embedding_dim": 16}})
    hold("embeddings", "FeatureEmbeddingDict",
         lib.FeatureEmbeddingDict(fm_dict, d, embedding_initializer=std, generator=gen), [X])
    hold("embeddings", "FeatureEmbedding_dynamic_dim",
         lib.FeatureEmbedding(fm_dict, d, embedding_initializer=std, generator=gen), [X],
         kw={"feature_type": "categorical", "dynamic_emb_dim": True})
    emb_layer = lib.FeatureEmbedding(with_specs({name: {"feature_encoder": avg}
                                                 for name in KKBOX_SEQUENCES}),
                                     d, embedding_initializer=std, generator=gen)
    hold("embeddings", "FeatureEmbedding", emb_layer, [X])
    with torch.no_grad():
        emb = emb_layer(X)                                              # [B, 6, F, d]
    x0 = emb[:, 0].contiguous()                                         # the target row
    flat, nbrs = x0.reshape(B, -1), emb[:, 1:].reshape(B, 5, -1).contiguous()

    for output in lib.InnerProductLayer.OUTPUTS:
        hold("interactions", "InnerProduct_" + output, lib.InnerProductLayer(F_, output),
             [x0])
    for kind in ("field_all", "field_each", "field_interaction"):
        hold("interactions", "Bilinear_" + kind,
             lib.BilinearInteractionLayer(F_, d, kind, generator=gen), [x0])
    for kind in lib.HolographicInteractionLayer.TYPES:
        hold("interactions", "Holographic_" + kind,
             lib.HolographicInteractionLayer(F_, kind), [x0])
    hold("interactions", "CrossNet", lib.CrossNet(F_ * d, 3, generator=gen), [flat])
    hold("interactions", "CIN", lib.CompressedInteractionNet(F_, (100, 100), generator=gen),
         [x0])
    hold("interactions", "InteractionMachine",
         lib.InteractionMachine(d, order=5, batch_norm=True, generator=gen), [x0])

    hold("tower", "SqueezeExcitation", lib.SqueezeExcitationLayer(F_, generator=gen), [x0])
    lr_spec = lib.EmbeddingSpec.build(fm, 1, force_dim=1)
    hold("tower", "FMLayer", lib.FMLayer(lr_spec, generator=gen), [X, x0])
    units = KKBOX_PARAMS["dnn_hidden_units"]
    for norm in ("batch_norm", "layer_norm"):
        for before in (True, False):
            hold("tower", "MLPBlock_{}_{}".format(norm, "before" if before else "after"),
                 lib.MLPBlock(F_ * d, units, output_dim=1, norm_before_activation=before,
                              **{norm: True}, generator=gen), [flat])

    mask = torch.from_numpy(np.random.RandomState(seed).rand(B, 5) > 0.2)
    hold("target_attention", "DIN_Attention",
         lib.DIN_Attention(F_ * d, attention_units=(80, 40), use_softmax=True,
                           generator=gen), [flat, nbrs, mask])
    hold("target_attention", "MultiHeadTargetAttention",
         lib.MultiHeadTargetAttention(F_ * d, F_ * d, num_heads=8, generator=gen),
         [flat, nbrs, mask])
    hold("target_attention", "Dice", lib.Dice(F_ * d), [flat])

    # BatchNorm keeps the hidden states at unit scale: without it a
    # weight generated from a layer's own input shrinks the output
    # quadratically, to ~1e-17 after four layers
    meta = {"hidden_units": [64], "hidden_activations": "relu"}
    hold("apg", "APGMLPLayer_self",
         lib.APGMLPLayer(F_ * d, 1, units, condition_mode="self", decompose_ranks=32,
                         batch_norm=True, meta_net_configs=meta, generator=gen), [flat])
    lens = mask[:, :4].sum(dim=1)
    hold("apg", "APGMLPLayer_moe_attention",
         lib.APGMLPLayer(F_ * d, 1, units, condition_mode="moe", decompose_ranks=32,
                         batch_norm=True,
                         meta_net_configs=dict(meta, input_dim=F_ * d, num_experts=4,
                                               aggregation="attention"), generator=gen),
         [flat, nbrs[:, :4].contiguous(), lens])

    hold("graphs", "FiGNN_Layer",
         lib.FiGNN_Layer(F_, d, gnn_layers=3, use_gru=True, use_residual=True,
                         generator=gen), [x0])
    t0 = time.perf_counter()
    ids = PETGraphProcessor.convert_indices(grid[..., :-1].astype(np.int64), fm.feature_specs)
    graphs = batch_graphs([PETGraphProcessor.build_instance_graph(ids[b], grid[b, :, -1])
                           for b in range(B)])
    edge_col = np.tile(np.tile(np.arange(n_cols), 6), 2 * B)
    graph_s = time.perf_counter() - t0
    hold("graphs", "PET_Layer", _PETGraph(fm, n_cols, d, 2, gen),
         [torch.from_numpy(graphs["original_node_ids"]), torch.from_numpy(graphs["label"]),
          torch.from_numpy(graphs["is_feature"]), torch.from_numpy(edge_col),
          torch.from_numpy(graphs["edge_src"].astype(np.int64)),
          torch.from_numpy(graphs["edge_dst"].astype(np.int64))])
    out["graphs"]["PET_Layer"].update(graphs=B, nodes=int(graphs["num_nodes"]),
                                      edges=len(graphs["edge_src"]), build_s=graph_s)
    for family, layers in out.items():
        print("nnlib: " + json.dumps({"family": family, "out_tol": NNLIB_OUT_TOL,
                                      "grad_tol": NNLIB_GRAD_TOL, "layers": layers}))
    misses = {"{}/{}".format(family, name): res for family, layers in out.items()
              for name, res in layers.items()
              if not (_held(res) or _held(res.get("float64", res)))}
    if misses:
        raise AssertionError("nnlib: card against CPU beyond the tolerance: "
                             + json.dumps(misses))
    return out


TMALL_CONFIG = os.path.join(REPO, "configs", "RAT_m2", "tmall_x1_002")
TMALL_EXPID = "RAT_m2_tmall_x1_002_retrieval"
TMALL_DATASET = "tmall_x1_002_retrieval"
# the rehearsal's row multiplier: 601,164 train, 634,960 test (the valid
# split) and 600,000 pool rows of Tmall's 20,038,830 / 21,165,358 /
# 20,000,000, for chip time
TMALL_SCALE = 0.03


def write_tmall_config(out_dir, dataset_id=None, batch_size=None):
    """A copy of configs/RAT_m2/tmall_x1_002 in ``out_dir`` whose dataset
    is ``dataset_id`` (the rehearsal builds ``<dataset_id>_s<scale>``,
    which its tail reads under that name) and, for a run on the CPU,
    whose batch is ``batch_size``; every width and setting else stays.
    Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(TMALL_CONFIG, "dataset_config.yaml")) as fh:
        dataset = fh.read()
    with open(os.path.join(TMALL_CONFIG, "model_config.yaml")) as fh:
        model = fh.read()
    if dataset_id is not None:
        header = re.compile(r"^{}:".format(re.escape(TMALL_DATASET)), re.M)
        if len(header.findall(dataset)) != 1:
            raise AssertionError("scripts: no single {} section".format(TMALL_DATASET))
        dataset = header.sub(dataset_id + ":", dataset)
        model = _set_key(model, "dataset_id", dataset_id)
    if batch_size is not None:
        model = _set_key(model, "batch_size", batch_size)
    for name, text in (("dataset_config.yaml", dataset), ("model_config.yaml", model)):
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(text)
    return out_dir


# (script, argv) of the scripts phase's in-process runs after the
# rehearsal: the profile at the ML-Tag and the Tmall bench shapes (8
# steps a window at Tmall's ~224 ms a step), the A/Bs at their defaults,
# the encoder A/B at ML-Tag's and at KKBox's widths, the health stamp
SCRIPT_RUNS = (
    ("profile_train_step", ["mltag"]),
    ("profile_train_step", ["tmall", "8"]),
    ("degraded_ab", []),
    ("dedup_ab", ["--time"]),
    ("tax_probe", []),
    ("gm_encoder_ab", ["--parity"]),
    ("gm_encoder_ab", ["--parity", "--s", "14", "--d", "40", "--heads", "8",
                       "--dim-head", "10", "--scale-dim", "2"]),
    ("chip_health", []),
)

# gm_encoder_ab's parity against the module encoder: the forward's
# largest absolute error, the largest per-leaf relative gradient error
#: the scripts phase's cut on the card: dedup_ab --time's windows of 128
#: steps (the script's default 256), for the whole run's time limit
SCRIPT_SIZES = {"dedup_ab": {"steps": 128}}
GM_FWD_ATOL = 1e-4
GM_GRAD_RTOL = 1e-3


def _tail_under_stall_guard(work_dir, config, rows, cuda, timeout=900):
    """tmall_rehearsal_tail under ``python -m
    rat_tpu_torch.scripts.stall_guard`` in ``work_dir``, as a user runs a
    long job; returns (its TMALL_REHEARSAL_TAIL dict, the guard's
    stderr). On a timeout the guard gets SIGTERM, on which it kills its
    child's process group."""
    cmd = [sys.executable, "-m", "rat_tpu_torch.scripts.stall_guard", "--stall-secs",
           "600", "--watch", "data/**/*.np[yz]", "--watch", "exps/**/*", "--",
           sys.executable, "-m", "rat_tpu_torch.scripts.tmall_rehearsal_tail",
           "--valid-rows", str(rows), "--config", config]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if not cuda:
        env.update(RAT_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=work_dir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise AssertionError("scripts (b): the tail ran past {} s".format(timeout))
    if proc.returncode != 0 or "killing" in err:
        raise AssertionError("scripts (b): stall_guard exited {}:\n{}".format(
            proc.returncode, err[-4000:]))
    lines = [l for l in out.splitlines() if l.startswith("TMALL_REHEARSAL_TAIL ")]
    if len(lines) != 1:
        raise AssertionError("scripts (b): no single TMALL_REHEARSAL_TAIL line")
    print(lines[0])
    return json.loads(lines[0].split(" ", 1)[1]), err


def scripts(device, work_dir, scale=TMALL_SCALE, tail_rows=100_000, runs=SCRIPT_RUNS,
            sizes=None, batch_size=None):
    """The JAX package's run scripts as ported (rat_tpu_torch.scripts),
    each through its ``main`` as a user runs it, in ``work_dir``:

    (a) tmall_rehearsal at ``scale`` (the slice's path: the CSVs, the
        build, the train and valid splits' retrieval against the explicit
        pool through K2, one epoch and the evaluations), with the launch
        counts zeroed just before and read just after; K2 = the two
        splits' query batches and K1 = K3 = 0 asserted (BatchNorm and
        dropout close K1's gate), the first K2 call held to its plain
        version, 512 neighbours of each split against plain scans, and
        on a card K2 timed at the path's batch against the pool;
    (b) tmall_rehearsal_tail on (a)'s build under stall_guard in a
        subprocess (exit 0, no kill);
    (c)-(h) ``runs``: each script's ``main(argv)`` in this process (with
        the keyword sizes of ``sizes[script]`` on the CPU), the profile's
        total and top 15 rows printed; gm_encoder_ab's parity held to
        GM_FWD_ATOL and GM_GRAD_RTOL, the health stamp without an error;
        no kernel launched (asserted).

    ``batch_size`` overrides the Tmall config's batch for a run on the
    CPU. Returns a dict of results with ``launches`` (those of (a)) and
    ``k2_tmall`` (K2's times at the Tmall shape, on a card)."""
    from rat_tpu_torch.scripts import (chip_health, dedup_ab, degraded_ab, gm_encoder_ab,
                                       profile_train_step, tax_probe, tmall_rehearsal)
    cuda = torch.device(device).type == "cuda"
    sizes = sizes or {}
    tag = "_s{:g}".format(scale)
    config = write_tmall_config(os.path.join(work_dir, "config"), batch_size=batch_size)
    cwd = os.getcwd()
    os.chdir(work_dir)
    try:
        k1.launches = k2.launches = k3.launches = 0
        with k2_held_to_plain("scripts (a)", max_calls=1) as compared:
            stages = tmall_rehearsal.main(["--scale", "{:g}".format(scale), "--config",
                                           config], device=device)
        launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
                    "bm25_score_chunk": k3.launches}
    finally:
        os.chdir(cwd)
    if sum(compared.values()) != 1:
        raise AssertionError("scripts (a): K2 held to its plain version in {} calls, "
                             "not 1".format(compared))

    data_dir = os.path.join(work_dir, "data", TMALL_DATASET + tag)
    fm = FeatureMap(TMALL_DATASET + tag, data_dir)
    fm.load(os.path.join(data_dir, "feature_map.json"))
    rc = tmall_rehearsal.retrieval_configs(load_config(config, TMALL_EXPID), fm)
    pool = np.load(os.path.join(data_dir, "retrieval_pool.npy"))
    splits, checked = {}, {}
    for split in ("train", "valid"):
        path = os.path.join(data_dir, split + ".npy")
        splits[split] = np.load(path)
        cached = np.load(retrieval_cache_path(path, rc["topK"]))
        checked[split] = check_neighbours(
            types.SimpleNamespace(retr_indices=cached["indices"],
                                  retr_values=cached["values"], retr_lens=cached["lens"]),
            pool, splits[split], rc, device, "scripts (a) " + split)
    expected = {"cross_intra_block": 0, "bm25_score_chunk": 0,
                "bm25_topk": sum(_k2_batches(len(splits[s]), rc) for s in splits)
                if cuda else 0}
    if launches != expected:
        raise AssertionError("scripts (a): launches {} against the expected {}".format(
            launches, expected))
    print("scripts (a) rows: train {}, valid {}, pool {}; K2 held to its plain version "
          "in its first call {}; neighbours checked {}".format(
              len(splits["train"]), len(splits["valid"]), len(pool), json.dumps(compared),
              json.dumps(checked)))
    k2_tmall = {}
    if cuda:
        # K2 at the path's batch (qry_batch_size train queries against the
        # pool, F=5), equal to its plain version, then timed; these
        # launches are not the path's
        used, batch = rc["used_col_indices"], rc["qry_batch_size"]
        same, args = _k2_case(pool[:, used].astype(np.int64),
                              splits["train"][:batch, used].astype(np.int64), rc["topK"],
                              device, pad4=True)
        if not same:
            raise AssertionError("scripts (a): K2 at the Tmall shape disagrees with its "
                                 "plain version")
        k2_tmall = dict(zip(("ms", "call_ms", "plain_ms", "bound_ms", "bound_by"),
                            _k2_times(*args)),
                        shape="B={} N={} F={} K={}".format(batch, len(pool), len(used),
                                                           rc["topK"]))
        print("K2 tmall_b{}_pool N={} F={} K={}: equal (exact), {:.4f} ms (bound {:.4f} "
              "ms), plain {:.3f} ms".format(batch, len(pool), len(used), rc["topK"],
                                            k2_tmall["ms"], k2_tmall["bound_ms"],
                                            k2_tmall["plain_ms"]))
        del args
        torch.cuda.empty_cache()

    tail_config = write_tmall_config(os.path.join(work_dir, "tail_config"),
                                     dataset_id=TMALL_DATASET + tag, batch_size=batch_size)
    tail, _ = _tail_under_stall_guard(work_dir, tail_config, tail_rows, cuda)

    modules = {"chip_health": chip_health, "dedup_ab": dedup_ab,
               "degraded_ab": degraded_ab, "gm_encoder_ab": gm_encoder_ab,
               "profile_train_step": profile_train_step, "tax_probe": tax_probe}
    results = []
    k1.launches = k2.launches = k3.launches = 0
    for name, argv in runs:
        t0 = time.perf_counter()
        kw = sizes.get(name, {})
        if name == "profile_train_step":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = modules[name].main(argv, device=device, **kw)
            for line in buf.getvalue().splitlines()[:16]:
                print("scripts profile_train_step {}: {}".format(" ".join(argv), line))
        else:
            res = modules[name].main(argv, device=device, **kw)
        if name == "gm_encoder_ab" and not (res["fwd_max_abs_err"] <= GM_FWD_ATOL and
                                            res["grad_max_abs_err"] <= GM_GRAD_RTOL):
            raise AssertionError("scripts: gm_encoder_ab {} differs from the module "
                                 "encoder: {}".format(argv, res))
        if name == "chip_health" and cuda and ("error" in res or not res["probe_valid"]):
            raise AssertionError("scripts: the health stamp failed: {}".format(res))
        if name == "dedup_ab" and not all(v > 0 for v in res["time"].values()):
            raise AssertionError("scripts: dedup_ab --time: {}".format(res["time"]))
        results.append((name, argv, time.perf_counter() - t0))
        print("scripts {} {}: {:.1f} s".format(name, " ".join(argv), results[-1][2]))
    after = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
             "bm25_score_chunk": k3.launches}
    if any(after.values()):
        raise AssertionError("scripts: the tools launched kernels {}".format(after))
    return {"rehearsal": stages, "tail": tail, "neighbours_checked": checked,
            "k2_tmall": k2_tmall, "launches": launches,
            "seconds": {"{} {}".format(n, " ".join(a)).strip(): s for n, a, s in results}}


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
    area = ctypes.c_int()
    fn = _build.load("cross_intra_block").k1_grad_occupancy
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    _build.check(fn(1 + MLTAG_RETRIEVAL["topK"], len(MLTAG_VOCAB) + 1, d, heads, dh,
                    MLTAG_PARAMS["scale_dim"] * d, 1, ctypes.byref(area), ctypes.byref(warps),
                    ctypes.byref(per_sm)), "K1 backward occupancy")
    print("K1 backward main path (d=10, dh=10): {} registers, {} CTAs of {} warps per SM, "
          "{} bytes of shared memory per warp".format(regs(k1_report, "k1_grad_kernel"),
                                                      per_sm.value, warps.value,
                                                      4 * area.value))
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
    kernels.append(check_emb_grad(args.seed, device))
    kernels.append(check_attention(rng, device))
    k3_checks = k3.launches      # K3 is on no path: none may follow
    # the embedding backward's and the attention kernel's launches by
    # path, taken after each path in this process (subprocesses' calls not
    # counted); train and kkbox_train count and assert their own
    emb_by_path, attn_by_path = {}, {}

    def count_path(path):
        if path is not None:
            emb_by_path[path] = emb_grad.launches
            attn_by_path[path] = {"forward": attn.launches, "backward": attn.grad_launches,
                                  "plain": attn.plain}
        emb_grad.launches = attn.launches = attn.grad_launches = attn.plain = 0

    count_path(None)

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
    count_path("serve")

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

        count_path("train")      # the attention's calls; train's own count is asserted
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
        count_path(None)          # the profiled steps after train and kkbox_train
        t0 = time.perf_counter()
        res, grouped_launches = grouped(trainer, train_gen, trainer.valid_gen, kk_trainer,
                                        kk_gen, args.seed)
        print("grouped: " + json.dumps(res))
        print_grouped(res)
        print("grouped launches (asserted: K1 = depth x steps of each graphed run, plain "
              "and dedup_neighbors, + depth x valid batches in each of the 2 grouped "
              "evaluations): "
              + json.dumps(grouped_launches))
        print("grouped phase: {:.1f} s".format(time.perf_counter() - t0))
        count_path("grouped")
        del kk_trainer, kk_gen, kk_train, kk_valid
        torch.cuda.empty_cache()

        res = variants(device, args.seed, train_gen, trainer.valid_gen, batch_size,
                       model_root)
        variant_launches = {k: sum(r["launches"][k] for r in res.values())
                            for k in ("cross_intra_block", "bm25_topk")}
        count_path("variants")

        t0 = time.perf_counter()
        res, scan_launches = mesh_scan(device, pool, test)
        print("mesh (a) sharded scan, {} shards in turn: {}".format(
            res["shards"], json.dumps(res)))
        print("mesh (a) launches (asserted: K2 = shards x query batches): "
              + json.dumps(scan_launches))
        res, train_launches_m = mesh_train(device, args.seed, pool, trainer.valid_gen,
                                           batch_size, model_root, train_gen, trainer)
        print("mesh (b) one-rank NCCL mesh: " + json.dumps(res))
        print_mesh_graphs(res["graphs"])
        print("mesh (b) launches (asserted: K1 = depth x (train steps + 4 x valid "
              "batches) in the fit, evaluations and round trips, + depth x steps of the "
              "graphed run + depth x valid batches in each of the 2 graphed "
              "evaluations; K2 = query batches of the 10 folds): "
              + json.dumps(train_launches_m))
        print("mesh phase: {:.1f} s".format(time.perf_counter() - t0))
        mesh_launches = {k: scan_launches[k] + train_launches_m[k] for k in scan_launches}
        count_path("mesh")
    del trainer, train_gen
    torch.cuda.empty_cache()
    if k3.launches != k3_checks:
        raise AssertionError("K3 was launched on a path")

    with tempfile.TemporaryDirectory() as work_dir:
        t0 = time.perf_counter()
        res = native(args.seed, work_dir)
        print("native: " + json.dumps(res))
        if res["python_h"]:
            for name in ("native", "python"):
                print("native {} build seconds: {}".format(
                    name, json.dumps(res[name + "_build_s"])))
        print("native phase: {:.1f} s".format(time.perf_counter() - t0))
        count_path(None)
        res = cli(device, args.seed, work_dir)
        cli_launches = res.pop("launches")
        count_path("cli")
        print("cli: " + json.dumps(res))
        print("cli launches (asserted: K1 = depth x (epochs x (train steps + valid "
              "batches) + valid batches + test batches), K2 = query batches of the 10 "
              "folds + the valid and test splits, K3 = 0; the rerun K2 = 0): "
              + json.dumps(cli_launches))
        res, block_launches = blocks(device, args.seed, work_dir)
        count_path("blocks")
        print("blocks: " + json.dumps(res))
        print("blocks launches (asserted from the block sizes: K1 = depth x (train steps "
              "+ 2 x valid batches + test batches) in each command; K2 (a) = query "
              "batches of each train block's 10 folds + the valid and test blocks, (b) = "
              "query batches of each train block x the other train blocks): "
              + json.dumps(block_launches))
    for name in ("a", "b"):
        run, stages = res[name], res[name]["stage_s"]
        print("blocks ({}) stage seconds: train retrieval per block {}, valid {}, test {}, "
              "epoch {}; peak split bytes {} (one block {}), max_memory_allocated {}"
              .format(name, stages["train_retrieval"], stages["valid_retrieval"],
                      stages["test_retrieval"], stages["epochs"], run["peak_split_bytes"],
                      run["one_block_bytes"], run["max_memory_allocated"]))

    uniform_pool, uniform_test = mltag_arrays(args.seed + 1, MLTAG_POOL_ROWS,
                                              MLTAG_TEST_ROWS, zipf_a=0.0)
    k1.launches = k2.launches = k3.launches = 0
    count_path(None)
    exact_match(device, args.seed, pool, test, uniform_pool, uniform_test)
    count_path("exact_match")
    exm_launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
                    "bm25_score_chunk": k3.launches}
    if any(exm_launches.values()):
        raise AssertionError("exact_match: kernels launched {}".format(exm_launches))
    print("exact_match launches (asserted 0: the window scan is plain PyTorch): "
          + json.dumps(exm_launches))

    t0 = time.perf_counter()
    print("bench: in-process steps (warm-up, window; in groups of up to 64 steps) {}; "
          "eval 100 steps; retrieval "
          "200,000 pool rows x 100,000 queries".format(json.dumps(BENCH_STEPS)))
    _, bench_launches, _ = bench(device)
    count_path("bench")
    print("bench launches (asserted per bench: K1 = depth x (warm-up + 3 x window) on "
          "the fused ML-Tag path, else 0; K2 = 2 calls x query batches of 2048 in "
          "the retrieval bench, else 0): " + json.dumps(bench_launches))
    print("bench phase: {:.1f} s; bench_scaling not run: it needs at least two "
          "cards".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        res, autotune_launches = autotune(device, args.seed, work_dir)
    count_path("autotune")
    print("autotune: " + json.dumps(res))
    print("autotune launches (the card run's log; asserted K1 > 0): "
          + json.dumps(autotune_launches))
    print("autotune phase: {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    k1.launches = k2.launches = k3.launches = 0
    with tempfile.TemporaryDirectory() as work_dir:
        res = precision(device, work_dir)
    count_path("precision")
    precision_launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
                          "bm25_score_chunk": k3.launches}
    if precision_launches != res.pop("launches"):
        raise AssertionError("precision: launches {} after the phase".format(
            precision_launches))
    print("precision: " + json.dumps(res))
    print("precision gate (RAT_m2, d=40, 8 heads, BatchNorm, {} / {} rows, {} epochs): "
          "float32 AUC {AUC:.6f} logloss {logloss:.6f} | bfloat16 (TF32) AUC {b[AUC]:.6f} "
          "logloss {b[logloss]:.6f} | |dAUC| {:.2e} < {}, |dlogloss| {:.2e} < {}".format(
              *res["rows"], res["epochs"], res["d_AUC"], GATE_AUC, res["d_logloss"],
              GATE_LOGLOSS, b=res["fits"]["bfloat16"], **res["fits"]["float32"]))
    for shape, by_setting in res["step_device_ms"].items():
        print("precision {} bench step, device ms per step in turns {}: float32 {}, "
              "TF32 {}".format(shape, "/".join(PRECISION_TURNS), by_setting["float32"],
                               by_setting["bfloat16"]))
    print("precision launches (asserted: K2 = 2 fits x query batches of the 2 folds and "
          "the valid split, K1 = K3 = 0): " + json.dumps(precision_launches))
    print("precision phase: {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    k1.launches = k2.launches = k3.launches = 0
    count_path(None)
    res = nnlib(device, args.seed)
    count_path("nnlib")
    nnlib_launches = {"cross_intra_block": k1.launches, "bm25_topk": k2.launches,
                      "bm25_score_chunk": k3.launches}
    if any(nnlib_launches.values()):
        raise AssertionError("nnlib: kernels launched {}".format(nnlib_launches))
    print("nnlib launches (asserted 0: the library runs in plain PyTorch): "
          + json.dumps(nnlib_launches))
    print("nnlib phase: {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        res = scripts(device, work_dir, sizes=SCRIPT_SIZES)
    count_path("scripts")
    scripts_launches = res.pop("launches")
    kernels[1].update({k + "_tmall_f5": v for k, v in res.pop("k2_tmall").items()})
    print("scripts: " + json.dumps(res))
    print("scripts launches (asserted: K2 = query batches of the rehearsal's train and "
          "valid splits, K1 = K3 = 0; the tail's subprocess and the tools after it "
          "launch none in this process): " + json.dumps(scripts_launches))
    print("scripts phase: {:.1f} s".format(time.perf_counter() - t0))
    by_path = {"serve": serve_launches, "train": train_launches,
               "kkbox_train": kkbox_launches, "grouped": grouped_launches,
               "variants": variant_launches,
               "cli": cli_launches,
               "blocks": {k: block_launches["a"][k] + block_launches["b"][k]
                          for k in block_launches["a"]},
               "exact_match": exm_launches, "mesh": mesh_launches,
               "bench": bench_launches, "autotune": autotune_launches,
               "precision": precision_launches, "scripts": scripts_launches}
    for entry in kernels[:3]:
        counts = {path: launches.get(entry["name"], 0)
                  for path, launches in by_path.items()}
        if entry["name"] in serve_launches:
            entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
    emb_by_path.update(train=train_launches["embedding_grad"],
                       kkbox_train=kkbox_launches["embedding_grad"])
    kernels[3]["launches_by_path"] = emb_by_path
    print("embedding_grad launches by path (this process's calls; asserted {} a train "
          "step in train and kkbox_train): {}".format(EMB_GRAD_PER_STEP,
                                                      json.dumps(emb_by_path)))
    attn_by_path["kkbox_train"] = kkbox_launches["attention"]
    kernels[4]["launches_by_path"] = attn_by_path
    print("attention launches by path (this process's calls; asserted {} forward and "
          "backward a train step and forward an eval batch in kkbox_train): {}".format(
              ATTENTION_PER_STEP, json.dumps(attn_by_path)))
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
