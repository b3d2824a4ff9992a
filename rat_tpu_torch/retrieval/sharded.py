"""Pool-sharded BM25 scan (port of rat_tpu.retrieval.sharded).

The retrieval pool is the long axis of this workload (about 20M rows
for Tmall). This scan cuts the POOL rows into shards over the mesh's
``data`` axis: every data rank scores its shard against the same query
batch and keeps its K best rows, the [B, K] winners are all-gathered
over the data group, and every rank merges them: a K-sized collective
instead of an N-sized one. Ranks of one model group hold the same shard
and compute the same thing.

Layout, as in the JAX package: the pool is padded to a multiple of
(chunk x shards) rows, shard s holds rows [s R, (s+1) R), and only the
first N rows are real. Each shard lives on its device field-major,
padded to a multiple of 4 columns, the layout kernel K2 takes.

Scoring, with the IDF of the whole pool:

- lucene: :func:`shard_topk` runs ``ops/bm25_topk.py::bm25_topk`` on the
  shard (kernel K2 on the card) with ``db_valid_len`` the shard's count
  of real rows, clamp(N - first_row, 0, R): a shard with no real rows,
  or fewer than K, gives score-0 slots, which the merge drops;
- Robertson (generation 1) takes the plain scan with ``neg_pad``, and
  exact match the plain dense-mask scan, ``(bm25 + 1) * 1[all
  exact-match columns equal]``, as the single-device engine does for
  both.

The merge (:func:`merge_topk`) concatenates the shards' winners
shard-major and keeps the first K of a stable descending sort: ties go
to the lowest global index, the order (score desc, index asc) of the
single-device engine (``torch.topk`` promises no tie order). Zero scores
drop to index -1 and ``lens`` counts the rest. Exact match then
overwrites the batches of the flat branch from the host, as the JAX
package does, so the output equals the single-device engine's.

:func:`shard_topk` and :func:`merge_topk` are plain functions, so one
process can also run all S shards in turn (``mesh=None, n_shards=S``):
what each rank of an S-rank world computes, without the world.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.bm25_topk import bm25_topk, bm25_topk_reference
from ..utils.device import resolve_device
from .bm25 import (RetrievalResults, _compute_idf_tables, _exm_flat_fill,
                   _exm_group_windows, _finalize, _idf_lookup, _idf_lookup_dense,
                   _pack_idf_dense, _pack_idf_tables)


def _round_up(x, m):
    return -(-x // m) * m


def shard_rows(n_rows, n_shards, topk, db_chunk_size=None):
    """Rows per shard: the pool padded to a multiple of (chunk x shards),
    with the chunk at least ``topk``."""
    chunk = n_rows if db_chunk_size is None else min(db_chunk_size, max(n_rows, 1))
    chunk = max(chunk, topk, 1)
    return _round_up(max(n_rows, chunk * n_shards), chunk * n_shards) // n_shards


def shard_pool(db_np_data, first_row, rows, device):
    """Pool rows [first_row, first_row + rows) as the field-major [F, C]
    int32 shard, C = ``rows`` padded to a multiple of 4; rows past the
    pool are zeros."""
    part = db_np_data[first_row: first_row + rows]
    db_T = torch.zeros((db_np_data.shape[1], rows + (-rows) % 4), dtype=torch.int32,
                       device=device)
    if len(part):
        db_T[:, :len(part)] = torch.from_numpy(
            np.ascontiguousarray(part.T, dtype=np.int32)).to(device)
    return db_T


def _exm_shard_scan(qry, qry_idf, db_T, valid_len, topk, rest_cols, exm_cols,
                    chunk=65536):
    """Plain dense exact-match scan of one shard: score ``(bm25 over
    rest_cols + 1)`` where every exact-match column is equal, else 0,
    rows at or past ``valid_len`` 0; the K best in the order (score
    desc, index asc). Returns (values [B, K] f32, shard-local indices
    [B, K] int64)."""
    B = qry.shape[0]
    C = db_T.shape[1]
    best_v = torch.empty((B, 0), dtype=torch.float32, device=qry.device)
    best_i = torch.empty((B, 0), dtype=torch.int64, device=qry.device)
    for c0 in range(0, C, chunk):
        c1 = min(c0 + chunk, C)
        scores = torch.zeros((B, c1 - c0), dtype=torch.float32, device=qry.device)
        for j, f in enumerate(rest_cols):
            eq = qry[:, f, None] == db_T[f, None, c0:c1]
            scores = scores + eq.to(torch.float32) * qry_idf[:, j, None]
        cand = torch.ones((B, c1 - c0), dtype=torch.bool, device=qry.device)
        for f in exm_cols:
            cand &= qry[:, f, None] == db_T[f, None, c0:c1]
        col = torch.arange(c0, c1, device=qry.device)
        keep = cand & (col[None, :] < valid_len)
        scores = torch.where(keep, scores + 1.0, torch.zeros_like(scores))
        cand_v = torch.cat([best_v, scores], dim=1)
        cand_i = torch.cat([best_i, col[None, :].expand(B, -1)], dim=1)
        v, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
        best_v = v[:, :topk]
        best_i = torch.gather(cand_i, 1, order[:, :topk])
    return best_v, best_i


def shard_topk(db_T, first_row, n_pool, qry, qry_idf, topk, neg_pad=False,
               exm=None, chunk_size=65536):
    """The K best rows of one shard for a query batch. ``db_T``: the
    shard (:func:`shard_pool`) holding global rows from ``first_row``;
    ``n_pool``: the pool's count of real rows; ``qry`` [B, F] int32 and
    ``qry_idf`` [B, F] f32 (with ``exm = (rest_cols, exm_cols)``,
    ``qry_idf`` covers ``rest_cols`` only). Returns (values [B, K] f32,
    GLOBAL indices [B, K] int64): lucene through :func:`bm25_topk`
    (kernel K2 on a CUDA device), Robertson (``neg_pad``) and exact
    match through plain scans."""
    rows = db_T.shape[1]
    valid = int(min(max(n_pool - first_row, 0), rows))
    if exm is not None:
        v, i = _exm_shard_scan(qry, qry_idf, db_T, valid, topk, *exm, chunk=chunk_size)
    elif neg_pad:
        v, i = bm25_topk_reference(qry, qry_idf, db_T, valid, topk,
                                   chunk_size=chunk_size, neg_pad=True)
    else:
        v, i = bm25_topk(qry, qry_idf, db_T, valid, topk)
    return v, i.to(torch.int64) + first_row


def merge_topk(values, indices, topk, neg_pad=False):
    """Merge the shards' winners (lists of [B, K], in shard order) into
    the first K of the order (score desc, global index asc), then drop
    zero scores. Returns (values [B, K] f32, indices [B, K] int64 with
    -1 for dropped slots, lens [B])."""
    V = torch.cat(values, dim=1)
    I = torch.cat(indices, dim=1)
    v, order = torch.sort(V, dim=1, descending=True, stable=True)
    return _finalize(v[:, :topk], torch.gather(I, 1, order[:, :topk]), neg_pad)


def _all_gather(t, group, n):
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def sharded_bm25_topk_retrieval(db_np_data, qry_np_data, mesh=None,
                                qry_batch_size=None, db_chunk_size=None, topK=10,
                                generation=4, idf_weighting=None, idf_tables=None,
                                exact_match_col_indices=None, n_shards=None,
                                device=None, timings=None, **kwargs):
    """bm25_topk_retrieval with the pool scan sharded over the ``data``
    axis of ``mesh`` (parallel/mesh.py): this rank scans its shard, the
    winners are all-gathered over the data group and merged. With
    ``mesh=None``, this process scans all ``n_shards`` shards in turn on
    ``device`` (None: CUDA) and merges them. The other arguments are
    bm25_topk_retrieval's (``idf_tables`` overrides the pool statistics,
    so that a resumable slice does not recount a large pool). Every rank
    returns the same RetrievalResults, equal to the single-device
    engine's.

    ``timings``, when a dict, receives ``scan_s`` and ``merge_s``: the
    seconds of the shard scans and of the gathers and merges (with a
    device sync after each)."""
    if generation not in (1, 2, 3, 4):
        raise ValueError("generation={}".format(generation))
    if idf_weighting is None:
        idf_weighting = "robertson" if generation == 1 else "lucene"
    robertson = idf_weighting == "robertson"
    exm = tuple(int(c) for c in exact_match_col_indices or ()) or None
    if exm:
        if robertson:
            raise ValueError("exact-match requires the lucene IDF (generations 2-4)")
        if idf_tables is not None:
            raise ValueError("an idf_tables override is not supported with "
                             "exact_match_cols")
    if mesh is not None:
        S, mine, device = mesh.data, [mesh.data_index], mesh.device
    else:
        if not n_shards:
            raise ValueError("without a mesh, give n_shards")
        S, mine, device = int(n_shards), list(range(int(n_shards))), \
            resolve_device(device)
    db_np_data = np.ascontiguousarray(db_np_data, dtype=np.int64)
    qry_np_data = np.ascontiguousarray(qry_np_data, dtype=np.int64)
    Q, N = len(qry_np_data), len(db_np_data)
    values = np.zeros((Q, topK), dtype=np.float64)
    indices = np.full((Q, topK), -1, dtype=np.int64)
    lens = np.zeros(Q, dtype=np.int64)
    if Q == 0 or N == 0:
        # an empty pool (a label-wise sub-pool with no rows) matches nothing
        return RetrievalResults(values, indices, lens)

    rest_cols = None
    if exm:
        rest_cols = tuple(c for c in range(db_np_data.shape[1]) if c not in exm)
        idf_tables = _compute_idf_tables(db_np_data[:, list(rest_cols)])
    elif idf_tables is None:
        idf_tables = _compute_idf_tables(db_np_data, idf_weighting)
    idf_pack = _pack_idf_dense(idf_tables, device)
    lookup = _idf_lookup_dense
    if idf_pack is None:
        idf_pack, lookup = _pack_idf_tables(idf_tables, device), _idf_lookup

    rows = shard_rows(N, S, topK, db_chunk_size)
    shards = {s: shard_pool(db_np_data, s * rows, rows, device) for s in mine}
    chunk = max(db_chunk_size or rows, topK, 1)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda and timings is not None \
        else (lambda: None)
    scan_s = merge_s = 0.0

    qry_dev = torch.from_numpy(qry_np_data.astype(np.int32)).to(device)
    batch = max(Q if qry_batch_size is None else qry_batch_size, 1)
    parts = []
    for lo in range(0, Q, batch):
        qry = qry_dev[lo: lo + batch]
        qry_idf = lookup(qry if rest_cols is None else qry[:, list(rest_cols)],
                         *idf_pack).contiguous()
        t0 = time.perf_counter()
        found = [shard_topk(shards[s], s * rows, N, qry, qry_idf, topK,
                            neg_pad=robertson,
                            exm=None if exm is None else (rest_cols, exm),
                            chunk_size=chunk) for s in mine]
        sync()
        t1 = time.perf_counter()
        vs, gis = [v for v, _ in found], [i for _, i in found]
        if mesh is not None:
            vs = _all_gather(vs[0], mesh.data_group, S)
            gis = _all_gather(gis[0], mesh.data_group, S)
        parts.append(merge_topk(vs, gis, topK, neg_pad=robertson))
        sync()
        scan_s += t1 - t0
        merge_s += time.perf_counter() - t1
    if timings is not None:
        timings.update(scan_s=scan_s, merge_s=merge_s)
    V, I, L = (torch.cat(x).cpu().numpy() for x in zip(*parts))
    values[:], indices[:], lens[:] = V, I, L

    if exm:
        # the batch-level flat branch of the single-device engine: a query
        # batch whose largest matched window fits in K (or that has no
        # other columns) takes its window in pool order, value 1.0
        perm, q_matched, q_starts, q_lens = _exm_group_windows(
            db_np_data, qry_np_data, list(exm))
        for lo in range(0, Q, batch):
            sl = slice(lo, min(lo + batch, Q))
            m = q_matched[sl]
            if not m.any():
                continue
            b_lens = q_lens[sl][m]
            if rest_cols and int(b_lens.max()) > topK:
                continue   # scored branch: the dense-mask scan stands
            out = np.nonzero(m)[0] + lo
            indices[out], values[out], lens[out] = _exm_flat_fill(
                q_starts[sl][m], b_lens, perm, N, topK)
    return RetrievalResults(values, indices, lens)
