"""Batched BM25-style top-K neighbor retrieval over categorical ID rows
(port of rat_tpu.retrieval.bm25).

Semantics, as in the JAX package:

- per-column IDF over the pool: ``log(N / count)`` ("lucene"), or
  ``log((N - count + 0.5) / (count + 0.5))`` with -1 pinned to 0
  ("robertson"), computed in float64 and cast to float32;
- query/pool score = sum over fields of ``1[q_f == db_f] * IDF(q_f)``,
  IDF 0 for values unseen in the pool;
- the K best rows in the order (score desc, pool index asc);
- zero-score results are dropped: index -> -1, ``lens`` counts the
  valid neighbors;
- exact match (``exact_match_col_indices``): a query only matches pool
  rows equal to it on those columns, scored ``bm25 + 1`` over the other
  columns (lucene IDF of the pool's other columns, whatever the IDF
  choice), in the order (score desc, pool index asc); a query batch
  whose largest matched window fits in K, or that has no other columns,
  takes the flat branch instead: its matches in pool order, value 1.0,
  the last K of a larger window kept.

On a CUDA device the lucene scan runs kernel K2
(ops/bm25_topk.py::bm25_topk). Robertson IDF can go negative, so it
always takes the plain scan with ``neg_pad``, the JAX package's own rule
(its fused kernel assumes non-negative scores). The JAX batching knobs
(128-row query rounding, 4096-row chunks, ``max_scores_per_dispatch``)
are TPU dispatch concerns; here ``qry_batch_size`` bounds the queries
per scan, and the main scan's outputs do not depend on it. Exact match's
do, through the flat branch, which is decided per batch of
``qry_batch_size`` queries cut from the first. Its window scan has no
Pallas kernel in the JAX package (XLA computes it), so here it is plain
PyTorch on the device.
"""

from collections import namedtuple

import numpy as np
import torch

from .. import tracing
from ..ops.bm25_topk import bm25_topk
from ..ops.bm25_topk import bm25_topk_reference as _scan_topk
from ..utils.device import resolve_device

RetrievalResults = namedtuple("RetrievalResults", ["values", "indices", "lens"])

# bincount allocates max(value)+1 slots; above this bound fall back to
# sort-based np.unique
_BINCOUNT_MAX_VALUE = 2 ** 25

# Above 64M vocab entries the dense IDF tables give way to the
# searchsorted lookup.
_DENSE_IDF_MAX_ENTRIES = 64_000_000

_I32_MAX = np.iinfo(np.int32).max


def _value_counts(col_data):
    """(sorted unique values, counts), np.unique(return_counts=True)
    semantics, via bincount when the column is non-negative and bounded."""
    if len(col_data) and 0 <= col_data.min() and \
            col_data.max() < _BINCOUNT_MAX_VALUE:
        full = np.bincount(col_data)
        keys = np.nonzero(full)[0].astype(np.int64)
        return keys, full[keys]
    return np.unique(col_data, return_counts=True)


def _compute_idf_tables(db_np_data, idf_weighting="lucene"):
    """Per-column (sorted_keys int64, idf float32) over the pool."""
    N = len(db_np_data)
    idf_tables = []
    for col in range(db_np_data.shape[1]):
        keys, counts = _value_counts(db_np_data[:, col])
        if idf_weighting == "robertson":
            idf = np.log((N - counts + 0.5) / (counts + 0.5)).astype(np.float32)
            idf[keys == -1] = 0.0
        elif idf_weighting == "lucene":
            idf = np.log(N / counts).astype(np.float32)
        else:
            raise ValueError("idf_weighting={!r}".format(idf_weighting))
        idf_tables.append((keys.astype(np.int64), idf))
    return idf_tables


def _pack_idf_tables(idf_tables, device):
    """Ragged per-column tables as padded device matrices for the
    searchsorted lookup: keys [F, Kmax] int32 (padded with INT32_MAX),
    vals [F, Kmax] f32, lens [F] int32."""
    F = len(idf_tables)
    kmax = max([len(k) for k, _ in idf_tables] + [1])
    keys = np.full((F, kmax), _I32_MAX, dtype=np.int32)
    vals = np.zeros((F, kmax), dtype=np.float32)
    lens = np.zeros((F,), dtype=np.int32)
    for f, (k, v) in enumerate(idf_tables):
        keys[f, :len(k)] = k
        vals[f, :len(v)] = v
        lens[f] = len(k)
    return tuple(torch.from_numpy(a).to(device) for a in (keys, vals, lens))


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _idf_lookup(qry, keys, vals, key_lens):
    """IDF per query cell, 0 for values unseen in the pool.
    qry [B, F] int32 -> [B, F] f32."""
    cols = []
    for f in range(qry.shape[1]):
        q = qry[:, f].contiguous()
        pos = torch.searchsorted(keys[f], q)
        pos_c = pos.clamp(0, keys.shape[1] - 1)
        hit = (keys[f][pos_c] == q) & (pos < key_lens[f])
        cols.append(torch.where(hit, vals[f][pos_c], torch.zeros_like(vals[f][pos_c])))
    return torch.stack(cols, dim=1)


def _pack_idf_dense(idf_tables, device):
    """All columns' IDF in ONE flat array indexed by ``offset[f] + value``.
    Returns (flat f32, offsets [F] int64, limits [F] int32 = largest pool
    value per column or -1), or None for negative keys or tables above
    _DENSE_IDF_MAX_ENTRIES. A query value unseen in the pool never
    equals a pool cell, so the IDF it maps to never reaches a score."""
    if any(len(k) and int(k[0]) < 0 for k, _ in idf_tables):
        return None
    sizes = [int(k[-1]) + 1 if len(k) else 1 for k, _ in idf_tables]
    if sum(sizes) > _DENSE_IDF_MAX_ENTRIES:
        return None
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    flat = np.zeros(sum(sizes), dtype=np.float32)
    limits = np.full(len(idf_tables), -1, dtype=np.int32)
    for f, (k, v) in enumerate(idf_tables):
        if len(k):
            flat[offsets[f] + k] = v
            limits[f] = k[-1]
    return tuple(torch.from_numpy(a).to(device) for a in (flat, offsets, limits))


def _idf_lookup_dense(qry, flat, offsets, limits):
    """Dense-gather IDF lookup. qry [B, F] int32 -> [B, F] f32."""
    in_range = (qry >= 0) & (qry <= limits[None, :])
    pos = torch.minimum(qry.clamp(min=0), limits.clamp(min=0)[None, :])
    vals = flat[offsets[None, :] + pos]
    return torch.where(in_range, vals, torch.zeros_like(vals))


def _finalize(v, i, neg_pad):
    """Zero-score drop: index -> -1 and ``lens`` = kept slots. With
    ``neg_pad`` the -inf padding slots surface as (0, -1) too."""
    if neg_pad:
        pad_hit = torch.isneginf(v)
        v = torch.where(pad_hit, torch.zeros_like(v), v)
        drop = (v == 0) | pad_hit
    else:
        drop = v == 0
    i = torch.where(drop, torch.full_like(i, -1), i)
    return v, i, (~drop).sum(dim=-1)


def _scan_topk_batched(db_T, qry_batches, idf_pack, db_valid_len, topk,
                       dense_idf, neg_pad, chunk_size):
    """IDF lookup + pool scan + zero-score drop for each query batch.
    Robertson (``neg_pad``) takes the plain scan everywhere; lucene takes
    :func:`bm25_topk`, kernel K2 on a CUDA device."""
    lookup = _idf_lookup_dense if dense_idf else _idf_lookup
    for qry in qry_batches:
        qry_idf = lookup(qry, *idf_pack).contiguous()
        if neg_pad:
            v, i = _scan_topk(qry, qry_idf, db_T, db_valid_len, topk,
                              chunk_size=chunk_size, neg_pad=True)
        else:
            v, i = bm25_topk(qry, qry_idf, db_T, db_valid_len, topk)
        yield _finalize(v, i, neg_pad)


def bm25_topk_retrieval(db_np_data, qry_np_data,
                        exact_match_col_indices=None,
                        qry_batch_size=None,
                        db_chunk_size=None,
                        topK=10,
                        idf_tables=None,
                        generation=4,
                        idf_weighting=None,
                        device=None,
                        **kwargs):
    """Retrieve the topK most similar pool rows for each query row.

    ``generation`` 1 selects Robertson IDF, 2/3/4 lucene;
    ``idf_weighting`` ("lucene"/"robertson") overrides it. ``idf_tables``
    overrides the per-column IDF statistics. ``exact_match_col_indices``
    restricts each query to the pool rows equal to it on those columns
    (not with generation 1 or ``idf_tables``). ``device`` None means CUDA
    (raises if absent); the scan, IDF lookup and drop run there.

    Returns RetrievalResults(values [Q,K] f64, indices [Q,K] i64 with -1
    padding, lens [Q] i64).
    """
    if generation not in (1, 2, 3, 4):
        raise ValueError("generation={}".format(generation))
    device = resolve_device(device)
    if idf_weighting is None:
        idf_weighting = "robertson" if generation == 1 else "lucene"
    robertson = idf_weighting == "robertson"
    with tracing.span("bm25.prepare"):
        db_np_data = np.ascontiguousarray(db_np_data, dtype=np.int64)
        qry_np_data = np.ascontiguousarray(qry_np_data, dtype=np.int64)
    N, F = db_np_data.shape
    Q = len(qry_np_data)
    if exact_match_col_indices:
        if generation == 1:
            raise ValueError("generation 1 has no exact-match prefilter")
        if idf_tables is not None:
            raise ValueError("an idf_tables override is not supported with "
                             "exact_match_cols")
        return _exact_match_retrieval(db_np_data, qry_np_data,
                                      exact_match_col_indices, qry_batch_size,
                                      topK, device)
    if idf_tables is None:
        with tracing.span("bm25.idf"):
            idf_tables = _compute_idf_tables(db_np_data, idf_weighting)
    with tracing.span("bm25.idf_pack") as sp:
        idf_pack = _pack_idf_dense(idf_tables, device)
        dense_idf = idf_pack is not None
        if not dense_idf:
            idf_pack = _pack_idf_tables(idf_tables, device)
        sp.add(bytes=_nbytes(idf_pack))

    # field-major pool with at least topK rows: when K exceeds the pool,
    # the padding rows (score 0, or -inf under neg_pad) take the surplus
    # slots and are dropped to -1, like the JAX scan's padded chunks.
    # Columns are padded to a multiple of 4, so that K2 copies its pool
    # tiles 16 bytes at a time; padding rows rank after every real row.
    cols = max(N, topK)
    with tracing.span("bm25.upload", bytes=4 * F * (N + Q)):
        db_T = torch.zeros((F, cols + (-cols) % 4), dtype=torch.int32, device=device)
        db_T[:, :N] = torch.from_numpy(db_np_data.T.astype(np.int32)).to(device)
        qry_dev = torch.from_numpy(qry_np_data.astype(np.int32)).to(device)
    qry_batch_size = Q if qry_batch_size is None else qry_batch_size
    qry_batches = torch.split(qry_dev, max(qry_batch_size, 1))
    chunk_size = max(db_chunk_size or N, topK, 1)

    with tracing.span("bm25.scan", calls=len(qry_batches)):
        parts = list(_scan_topk_batched(db_T, qry_batches, idf_pack, N, topK,
                                        dense_idf, robertson, chunk_size))
    if not parts:
        return RetrievalResults(np.zeros((0, topK)), np.zeros((0, topK), np.int64),
                                np.zeros(0, np.int64))
    with tracing.span("bm25.collect") as sp:
        V, I, L = (torch.cat(x) for x in zip(*parts))
        sp.add(bytes=_nbytes((V, I, L)))
        return RetrievalResults(V.cpu().numpy().astype(np.float64),
                                I.cpu().numpy().astype(np.int64),
                                L.cpu().numpy().astype(np.int64))


def _rows_as_void(a):
    """View [N, F] int rows as a structured array of N lexicographically
    comparable records, so row-wise sort and searchsorted are one call."""
    a = np.ascontiguousarray(a)
    return a.view([("f%d" % i, a.dtype) for i in range(a.shape[1])]).ravel()


def _exm_group_windows(db_np_data, qry_np_data, exact_match_col_indices):
    """The pool stably sorted by its exact-match key, so that each key is
    a window of rows in ascending pool index, and each query's window.
    Returns (perm, q_matched [Q] bool, q_starts [Q] window start in
    sorted order, q_lens [Q] window length, 0 when unmatched)."""
    N = len(db_np_data)
    exm_mask = np.zeros(db_np_data.shape[1], dtype=bool)
    exm_mask[exact_match_col_indices] = True
    db_keys = _rows_as_void(db_np_data[:, exm_mask])
    perm = np.argsort(db_keys, kind="stable")
    sorted_keys = db_keys[perm]
    is_start = np.ones(N, dtype=bool)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    grp_starts = np.nonzero(is_start)[0].astype(np.int64)
    grp_lens = np.diff(np.append(grp_starts, N))
    uniq_keys = sorted_keys[grp_starts]

    qry_keys = _rows_as_void(qry_np_data[:, exm_mask])
    gid = np.searchsorted(uniq_keys, qry_keys)
    gid_c = np.minimum(gid, len(uniq_keys) - 1)
    q_matched = uniq_keys[gid_c] == qry_keys
    q_starts = grp_starts[gid_c]
    q_lens = np.where(q_matched, grp_lens[gid_c], 0)
    return perm, q_matched, q_starts, q_lens


def _exm_flat_fill(b_starts, b_lens, perm, n_pool, topk):
    """The flat branch: each query's window in pool order with value
    1.0, cut to the LAST ``topk`` rows of a larger window. Returns
    (indices [B, K] i64 with -1 padding, values [B, K] f64, lens [B]
    i64)."""
    flat_offs = np.arange(topk, dtype=np.int64)
    take_len = np.minimum(b_lens, topk)
    win_starts = b_starts + b_lens - take_len
    pos = np.minimum(win_starts[:, None] + flat_offs[None, :], n_pool - 1)
    valid = flat_offs[None, :] < take_len[:, None]
    idx = np.where(valid, perm[pos], -1)
    return idx, valid.astype(np.float64), take_len.astype(np.int64)


#: window rows scored per pass of the window scan
_EXM_CHUNK_ROWS = 4096
_OFFSET_MASK = 0xFFFFFFFF


def _exm_window_topk(db_rest_T, qry, qry_idf, starts, lens, topk):
    """Each query scores only its own window of the key-sorted pool.

    db_rest_T: [F, N] int32, the other columns in key-sorted order;
    qry/qry_idf: [B, F] int32 / f32; starts/lens: [B] host int64 windows.
    Returns (values [B, K] f32, ``bm25 + 1`` with 0 for no row,
    positions [B, K] int64 into the sorted order), in the order (value
    desc, window offset asc), as ``lax.top_k`` per chunk and again over
    the chunk-major concatenation gives it.

    A candidate is kept as one int64 key, its value's bits (non-negative
    float32 bits order as the floats do) over the complement of its
    window offset, so that ``torch.topk`` of distinct keys has one
    answer: higher value first, then lower offset. Queries run longest
    window first, and a pass over window rows [c0, c0 + chunk) takes
    only the queries whose window reaches c0."""
    device = qry.device
    B, F = qry.shape
    order = np.argsort(-lens, kind="stable")
    lens_desc = lens[order]
    order_t = torch.from_numpy(order).to(device)
    qry, qry_idf = qry[order_t], qry_idf[order_t]
    starts_t = torch.from_numpy(starts[order]).to(device)
    lens_t = torch.from_numpy(lens_desc).to(device)
    # key 0: value 0 (dropped) at the largest offset
    best = torch.zeros((B, topk), dtype=torch.int64, device=device)
    n_rows = db_rest_T.shape[1]
    longest = int(lens_desc[0])
    chunk = max(1, min(longest, _EXM_CHUNK_ROWS))
    local = torch.arange(chunk, dtype=torch.int64, device=device)
    for c0 in range(0, longest, chunk):
        active = int(np.count_nonzero(lens_desc > c0))
        offs = c0 + local
        valid = offs[None, :] < lens_t[:active, None]
        pos = torch.where(valid, starts_t[:active, None] + offs[None, :], 0)
        pos = pos.clamp_(max=n_rows - 1)
        scores = torch.zeros((active, chunk), dtype=torch.float32, device=device)
        for f in range(F):
            eq = qry[:active, f, None] == db_rest_T[f][pos]
            scores = scores + eq.to(torch.float32) * qry_idf[:active, f, None]
        # every true candidate is an exact match: score floor 1
        scores = torch.where(valid, scores + 1.0, torch.zeros_like(scores))
        keys = (scores.view(torch.int32).to(torch.int64) << 32) \
            | (_OFFSET_MASK - offs)[None, :]
        best[:active] = torch.topk(torch.cat([best[:active], keys], dim=1),
                                   topk, dim=1).values
    values = (best >> 32).to(torch.int32).view(torch.float32)
    positions = starts_t[:, None] + (_OFFSET_MASK - (best & _OFFSET_MASK))
    inverse = torch.empty_like(order_t)
    inverse[order_t] = torch.arange(B, device=device)
    return values[inverse], positions[inverse]


def _exact_match_retrieval(db_np_data, qry_np_data, exact_match_col_indices,
                           qry_batch_size, topK, device):
    """Exact-match retrieval (rat_tpu.retrieval.bm25._exact_match_retrieval):
    the pool's key windows on the host, then per batch of
    ``qry_batch_size`` queries cut from the first, either the flat branch
    on the host or the window scan on the device. A batch's branch
    depends on the whole batch, so queries never move between batches.
    Returns RetrievalResults as :func:`bm25_topk_retrieval`."""
    Q, N = len(qry_np_data), len(db_np_data)
    values = np.zeros((Q, topK), dtype=np.float64)
    indices = np.full((Q, topK), -1, dtype=np.int64)
    lens = np.zeros(Q, dtype=np.int64)
    if N == 0:
        # an empty pool (a label-wise sub-pool with no rows) matches nothing
        return RetrievalResults(values, indices, lens)
    exm_mask = np.zeros(db_np_data.shape[1], dtype=bool)
    exm_mask[exact_match_col_indices] = True
    perm, q_matched, q_starts, q_lens = _exm_group_windows(
        db_np_data, qry_np_data, exact_match_col_indices)
    db_rest = db_np_data[:, ~exm_mask]
    qry_rest = qry_np_data[:, ~exm_mask]
    has_rest = db_rest.shape[1] > 0
    qry_batch_size = Q if qry_batch_size is None else max(qry_batch_size, 1)

    scan = None
    for lo in range(0, Q, qry_batch_size):
        sl = slice(lo, min(lo + qry_batch_size, Q))
        m = q_matched[sl]
        if not m.any():
            continue
        b_starts, b_lens = q_starts[sl][m], q_lens[sl][m]
        out_rows = np.nonzero(m)[0] + lo
        if not has_rest or int(b_lens.max()) <= topK:
            indices[out_rows], values[out_rows], lens[out_rows] = _exm_flat_fill(
                b_starts, b_lens, perm, N, topK)
            continue
        if scan is None:
            # the other columns' lucene IDF over the pool, and those
            # columns in key-sorted order, field-major, on the device
            idf_tables = _compute_idf_tables(db_rest)
            idf_pack = _pack_idf_dense(idf_tables, device)
            lookup = _idf_lookup_dense
            if idf_pack is None:
                idf_pack, lookup = _pack_idf_tables(idf_tables, device), _idf_lookup
            db_rest_T = torch.from_numpy(
                np.ascontiguousarray(db_rest[perm].T, dtype=np.int32)).to(device)
            scan = (idf_pack, lookup, db_rest_T)
        idf_pack, lookup, db_rest_T = scan
        qry = torch.from_numpy(qry_rest[sl][m].astype(np.int32)).to(device)
        v, pos = _exm_window_topk(db_rest_T, qry, lookup(qry, *idf_pack).contiguous(),
                                  b_starts, b_lens, topK)
        v, pos = v.cpu().numpy(), pos.cpu().numpy()
        keep = v > 0
        indices[out_rows] = np.where(keep, perm[np.minimum(pos, N - 1)], -1)
        values[out_rows] = np.where(keep, v.astype(np.float64), 0.0)
        lens[out_rows] = keep.sum(-1)
    return RetrievalResults(values, indices, lens)
