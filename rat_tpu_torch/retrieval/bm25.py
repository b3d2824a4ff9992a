"""Batched BM25-style top-K neighbor retrieval over categorical ID rows
(port of rat_tpu.retrieval.bm25, without the exact-match path).

Semantics, as in the JAX package:

- per-column IDF over the pool: ``log(N / count)`` ("lucene"), or
  ``log((N - count + 0.5) / (count + 0.5))`` with -1 pinned to 0
  ("robertson"), computed in float64 and cast to float32;
- query/pool score = sum over fields of ``1[q_f == db_f] * IDF(q_f)``,
  IDF 0 for values unseen in the pool;
- the K best rows in the order (score desc, pool index asc);
- zero-score results are dropped: index -> -1, ``lens`` counts the
  valid neighbors.

On a CUDA device the lucene scan runs kernel K2
(ops/bm25_topk.py::bm25_topk). Robertson IDF can go negative, so it
always takes the plain scan with ``neg_pad``, the JAX package's own rule
(its fused kernel assumes non-negative scores). The JAX batching knobs
(128-row query rounding, 4096-row chunks, ``max_scores_per_dispatch``)
are TPU dispatch concerns; here ``qry_batch_size`` bounds the queries
per scan, and the outputs do not depend on it.
"""

from collections import namedtuple

import numpy as np
import torch

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
    overrides the per-column IDF statistics. ``device`` None means CUDA
    (raises if absent); the scan, IDF lookup and drop run there.

    Returns RetrievalResults(values [Q,K] f64, indices [Q,K] i64 with -1
    padding, lens [Q] i64).
    """
    if generation not in (1, 2, 3, 4):
        raise ValueError("generation={}".format(generation))
    if exact_match_col_indices:
        raise NotImplementedError(
            "exact-match retrieval is not ported yet (ROADMAP.md, Queue 1 "
            "item 7: exact-match retrieval)")
    device = resolve_device(device)
    if idf_weighting is None:
        idf_weighting = "robertson" if generation == 1 else "lucene"
    robertson = idf_weighting == "robertson"
    db_np_data = np.ascontiguousarray(db_np_data, dtype=np.int64)
    qry_np_data = np.ascontiguousarray(qry_np_data, dtype=np.int64)
    N, F = db_np_data.shape
    Q = len(qry_np_data)
    if idf_tables is None:
        idf_tables = _compute_idf_tables(db_np_data, idf_weighting)
    idf_pack = _pack_idf_dense(idf_tables, device)
    dense_idf = idf_pack is not None
    if not dense_idf:
        idf_pack = _pack_idf_tables(idf_tables, device)

    # field-major pool with at least topK rows: when K exceeds the pool,
    # the padding rows (score 0, or -inf under neg_pad) take the surplus
    # slots and are dropped to -1, like the JAX scan's padded chunks.
    # Columns are padded to a multiple of 4, so that K2 copies its pool
    # tiles 16 bytes at a time; padding rows rank after every real row.
    cols = max(N, topK)
    db_T = torch.zeros((F, cols + (-cols) % 4), dtype=torch.int32, device=device)
    db_T[:, :N] = torch.from_numpy(db_np_data.T.astype(np.int32)).to(device)
    qry_dev = torch.from_numpy(qry_np_data.astype(np.int32)).to(device)
    qry_batch_size = Q if qry_batch_size is None else qry_batch_size
    qry_batches = torch.split(qry_dev, max(qry_batch_size, 1))
    chunk_size = max(db_chunk_size or N, topK, 1)

    parts = list(_scan_topk_batched(db_T, qry_batches, idf_pack, N, topK,
                                    dense_idf, robertson, chunk_size))
    if not parts:
        return RetrievalResults(np.zeros((0, topK)), np.zeros((0, topK), np.int64),
                                np.zeros(0, np.int64))
    V, I, L = (torch.cat(x) for x in zip(*parts))
    return RetrievalResults(V.cpu().numpy().astype(np.float64),
                            I.cpu().numpy().astype(np.int64),
                            L.cpu().numpy().astype(np.int64))
