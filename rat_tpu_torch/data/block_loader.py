"""Streaming multi-block splits (port of rat_tpu.data.block_loader).

A dataset built with ``data_block_size > 0`` writes ``<split>_part_<i>``
blocks: ``.npy`` from the port's build, ``.h5`` from the JAX package's.
DataBlockGenerator iterates them block by block, the block order and
each block's rows shuffled with the caller's RNG, with the same
per-block X-fold self-retrieval or pool retrieval as a one-block split
and a cache per block beside it, ``retrieval_{K}_<block>`` (``.npz``
beside a ``.npy`` block, the JAX package's ``.h5`` beside an ``.h5``
block, so the two packages share caches on ``.h5`` data).

``inter_block_retrieval: true`` retrieves each block's rows from the
union of all OTHER blocks instead (_inter_block_retrieval): union-pool
IDF, one pool block in memory at a time, and the neighbours' rows kept
in the cache, so that neither training nor evaluation ever needs more
than one block. Its cache name carries a digest of the block set.

The trainer uploads one block view at a time (engine/trainer.py).
Under a mesh, block caches are written as the one-block split's are
(data/loader.py): by rank 0, then read back by every rank.
"""

import hashlib
import logging
import os
import time
from collections import Counter

import numpy as np

from ..parallel.distributed import from_rank0, on_rank0
from ..retrieval.bm25 import bm25_topk_retrieval
from .io import array_rows, load_arrays, load_hdf5
from .loader import (SplitBatches, _fold_self_retrieval, _pool_retrieval,
                     count_positives, retrieval_cache_path, save_retrieval_cache)


def _load_block(path):
    """A ``.npy`` or ``.h5`` block, read without a log line."""
    if path.endswith(".h5"):
        return load_hdf5(path, verbose=False)
    return np.load(path)


def _union_idf_tables(block_arrays, used_cols, idf_weighting="lucene"):
    """Per-column IDF over the union of blocks, counted one block at a
    time (``block_arrays`` yields them). ``idf_weighting`` as in
    retrieval.bm25._compute_idf_tables. Returns (tables, rows)."""
    counters = [Counter() for _ in used_cols]
    N = 0
    for arr in block_arrays():
        data = arr[:, used_cols].astype(np.int64)
        N += len(data)
        for c in range(data.shape[1]):
            keys, counts = np.unique(data[:, c], return_counts=True)
            counters[c].update(dict(zip(keys.tolist(), counts.tolist())))
    tables = []
    for c in range(len(used_cols)):
        keys = np.array(sorted(counters[c]), dtype=np.int64)
        counts = np.array([counters[c][k] for k in keys], dtype=np.float64)
        if idf_weighting == "robertson":
            idf = np.log((N - counts + 0.5) / (counts + 0.5)).astype(np.float32)
            idf[keys == -1] = 0.0
        elif idf_weighting == "lucene":
            idf = np.log(N / counts).astype(np.float32)
        else:
            raise ValueError("idf_weighting={!r}".format(idf_weighting))
        tables.append((keys, idf))
    return tables, N


def _inter_block_retrieval(block_paths, qry_block_index, qry_darray,
                           retrieval_configs, device=None):
    """Retrieve block ``qry_block_index``'s rows from the union of all
    OTHER blocks.

    IDF comes from the union pool (a first pass over the other blocks);
    each other block is then scanned with those tables (kernel K2 on the
    card) and its top K merged into the running best on the host in the
    order (score desc, global index asc). Global indices count rows of
    all blocks in file order, the query block's included (its own rows
    are never candidates). The neighbours' rows are returned too,
    ``neighbor_rows`` [N, K, F+1]; a dropped neighbour (score 0, index
    -1) takes the last row of the last other block scanned, as the
    one-block path's -1 gather wraps to the pool's last row.

    Returns (indices [N, K] i64, values [N, K] f64, lens [N] i64,
    neighbor_rows [N, K, F+1])."""
    rc = retrieval_configs
    if rc.get("label_wise", False):
        raise ValueError("inter_block_retrieval does not support label_wise")
    if rc.get("exact_match_col_indices"):
        raise ValueError("inter_block_retrieval does not support exact_match_cols")
    # the merge below ranks dropped slots at -1.0, which Robertson's
    # negative scores would outrank; resolve the weighting as
    # bm25_topk_retrieval does: an explicit idf_weighting wins, else
    # generation 1 means Robertson
    effective_idf = rc.get("idf_weighting") or \
        ("robertson" if rc.get("generation", 4) == 1 else "lucene")
    if effective_idf == "robertson":
        raise ValueError("inter_block_retrieval supports only the lucene IDF "
                         "(non-negative scores)")
    used_cols = rc["used_col_indices"]
    topK = rc["topK"]
    others = [(j, p) for j, p in enumerate(block_paths) if j != qry_block_index]

    def other_arrays():
        for _, p in others:
            yield _load_block(p)

    idf_tables, _ = _union_idf_tables(other_arrays, used_cols)
    rows = [len(qry_darray) if j == qry_block_index else array_rows(p)
            for j, p in enumerate(block_paths)]
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)

    qry = qry_darray[:, used_cols].astype(int)
    N = len(qry)
    best_v = np.zeros((N, 0), dtype=np.float64)
    best_i = np.zeros((N, 0), dtype=np.int64)
    best_rows = np.zeros((N, 0, qry_darray.shape[1]), dtype=qry_darray.dtype)
    engine_kwargs = {k: v for k, v in rc.items() if k != "exact_match_col_indices"}
    last_row = None
    for j, p in others:
        db_arr = _load_block(p)
        last_row = db_arr[-1]
        res = bm25_topk_retrieval(db_np_data=db_arr[:, used_cols].astype(int),
                                  qry_np_data=qry, idf_tables=idf_tables,
                                  device=device, **engine_kwargs)
        keep = res.values > 0
        best_v = np.concatenate([best_v, np.where(keep, res.values, -1.0)], axis=1)
        best_i = np.concatenate([best_i, np.where(keep, res.indices + offsets[j], 2**62)],
                                axis=1)
        best_rows = np.concatenate([best_rows, db_arr[np.where(keep, res.indices, 0)]],
                                   axis=1)
        # keep the running top K in the order (score desc, index asc)
        order = np.lexsort((best_i, -best_v))[:, :topK]
        best_v = np.take_along_axis(best_v, order, axis=1)
        best_i = np.take_along_axis(best_i, order, axis=1)
        best_rows = np.take_along_axis(best_rows, order[..., None], axis=1)
    drop = best_v <= 0
    values = np.where(drop, 0.0, best_v)
    indices = np.where(drop, -1, best_i)
    lens = (~drop).sum(-1).astype(np.int64)
    neighbor_rows = np.where(drop[..., None], last_row[None, None, :], best_rows)
    return indices, values, lens, neighbor_rows


class DataBlockGenerator(object):
    """A split of several blocks, streamed one block view at a time.

    Holds the reference's counters (num_samples, num_positives,
    num_negatives, num_batches, num_blocks) without keeping any block.
    ``retrieval_s`` maps each block's file name to the seconds of its
    first retrieval in this process (computed, or read from its cache).
    """

    def __init__(self, data_block_list, batch_size=32, shuffle=False,
                 feature_map=None, retrieval_configs=None,
                 retrieval_pool_fname=None, retrieval_augmented=False,
                 device=None, **kwargs):
        self.data_blocks = list(data_block_list)
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.feature_map = feature_map
        self.retrieval_configs = retrieval_configs
        self.retrieval_pool_fname = retrieval_pool_fname
        self.retrieval_augmented = retrieval_augmented
        self.device = device
        self.num_blocks = len(self.data_blocks)
        self.retrieval_s = {}
        self._pool_cache = None   # an external pool file, read at most once
        self._digest = None
        (self.num_batches, self.num_samples,
         self.num_positives, self.num_negatives) = self._count()

    @property
    def topk(self):
        """Neighbours per sample, without touching any block."""
        if not self.retrieval_augmented or self.retrieval_configs is None:
            return 0
        k = self.retrieval_configs["topK"]
        return 2 * k if self.retrieval_configs.get("label_wise") else k

    def _pool_array(self):
        if self._pool_cache is None:
            self._pool_cache = _load_block(self.retrieval_pool_fname)
        return self._pool_cache

    def _count(self):
        num_samples = num_positives = num_batches = 0
        for block_path in self.data_blocks:
            arr = _load_block(block_path)
            num_samples += len(arr)
            num_positives += count_positives(arr)
            num_batches += int(np.ceil(len(arr) * 1.0 / self.batch_size))
        return num_batches, num_samples, num_positives, num_samples - num_positives

    def _block_set_digest(self):
        """Short digest of the block list (file names and row counts).
        Inter-block retrieval depends on every block (union IDF, global
        indices), so its caches must change name when a block is added,
        removed, reordered or resized."""
        if self._digest is None:
            h = hashlib.sha256()
            for p in self.data_blocks:
                h.update(("%s:%d;" % (os.path.basename(p), array_rows(p))).encode())
            self._digest = h.hexdigest()[:10]
        return self._digest

    def _block_retrieval(self, block_path, darray):
        """Returns (indices, values, lens, neighbor_rows or None)."""
        rc = self.retrieval_configs
        if not rc.get("pre_retrieval", True):
            raise NotImplementedError("only the pre-retrieval strategy is implemented")
        inter_block = (self.retrieval_pool_fname == "self"
                       and rc.get("inter_block_retrieval", False)
                       and self.num_blocks > 1)
        tag = "inter_%s_" % self._block_set_digest() if inter_block else ""
        cache = retrieval_cache_path(block_path, rc["topK"], tag)
        mesh = rc.get("mesh")

        def read():
            got = load_arrays(cache)
            return (got["indices"], got["values"], got["lens"],
                    got.get("neighbor_rows"))

        if from_rank0(mesh, lambda: os.path.exists(cache)):
            return read()
        rows = None
        if inter_block:
            idx, vals, lens, rows = _inter_block_retrieval(
                self.data_blocks, self.data_blocks.index(block_path), darray, rc,
                self.device)
        elif self.retrieval_pool_fname == "self":
            idx, vals, lens = _fold_self_retrieval(darray, rc, self.device)
        else:
            idx, vals, lens = _pool_retrieval(darray, self._pool_array(), rc, self.device)
        payload = {"indices": idx, "values": vals, "lens": lens}
        if rows is not None:
            payload["neighbor_rows"] = rows
        on_rank0(mesh, lambda: save_retrieval_cache(payload, cache))
        if mesh is not None:
            return read()
        return idx, vals, lens, rows

    def iter_block_views(self, rng=None):
        """Yield one DataGenerator-shaped view per block. The block order
        is drawn from ``rng`` when the first view is asked for, each
        view's rows when its batches are."""
        blocks = list(self.data_blocks)
        if self.shuffle:
            (rng or np.random).shuffle(blocks)
        for block_path in blocks:
            darray = _load_block(block_path)
            view = _BlockView(darray, self.batch_size, self.shuffle)
            if self.retrieval_configs is not None:
                t0 = time.perf_counter()
                idx, vals, lens, rows = self._block_retrieval(block_path, darray)
                self.retrieval_s.setdefault(os.path.basename(block_path),
                                            time.perf_counter() - t0)
                if not self.retrieval_augmented:
                    logging.info("[[WARNING]] dataloader provided retrieved samples but "
                                 "the model doesn't enable retrieval-augmented mode.")
                elif rows is not None:
                    # inter-block: the neighbours' rows are the pool, in
                    # the identity layout
                    n, k = rows.shape[:2]
                    view.attach_retrieval(rows.reshape(n * k, -1),
                                          np.arange(n * k, dtype=np.int64).reshape(n, k),
                                          vals, lens)
                else:
                    pool = darray if self.retrieval_pool_fname == "self" \
                        else self._pool_array()
                    view.attach_retrieval(pool, idx, vals, lens)
            yield view

    def __len__(self):
        return self.num_batches


class _BlockView(SplitBatches):
    """DataGenerator-shaped view of one loaded block."""

    def __init__(self, darray, batch_size, shuffle):
        self.darray = darray
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.retrieval_augmented = False
        self.pool_darray = None
        self.retr_indices = None
        self.retr_values = None
        self.retr_lens = None
        self.num_samples = len(darray)
        self.num_batches = int(np.ceil(self.num_samples / batch_size))

    def attach_retrieval(self, pool, idx, vals, lens):
        if not len(self.darray) == len(idx) == len(vals) == len(lens):
            raise ValueError("retrieval cache length mismatch for this block "
                             "(block={}, cache={})".format(len(self.darray), len(idx)))
        self.retrieval_augmented = True
        self.pool_darray = pool
        self.retr_indices = idx.astype(np.int64)
        self.retr_values = vals
        self.retr_lens = lens
