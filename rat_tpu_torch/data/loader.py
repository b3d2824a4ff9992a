"""Data loading runtime: splits + retrieval precompute + index batching
(port of rat_tpu.data.loader, single device).

Retrieval precompute keeps the reference's semantics:

- X-fold self-retrieval: split the split's own rows into contiguous
  folds; queries = fold i, pool = all other folds; map local -> global;
- pool retrieval: split queries against an external pool (valid/test
  against the first train block under X-fold);
- label_wise: separate pos-pool and neg-pool retrievals concatenated to
  2K neighbors;
- results cached next to the split with keys indices/values/lens: an
  ``.npy`` split (the port's build) to ``retrieval_{topK}_<stem>.npz``,
  an ``.h5`` split to the JAX package's ``retrieval_{topK}_<name>.h5``,
  so the two packages share caches on ``.h5`` data;
- a long scan runs in checkpointed slices of ``resume_slice_rows``
  queries (retrieval configs; default 2,000,000) through a
  _PartialRetrievalStore, so a killed precompute resumes from its last
  completed slice.

A split of more than one block streams through
``data/block_loader.py::DataBlockGenerator``.

Under a mesh (``retrieval_configs["mesh"]``, set by the CLI), a pool of
at least ``sharded_pool_min_rows`` rows (default 2,000,000) is scanned by
the pool-sharded engine (retrieval/sharded.py), each data rank its shard;
a smaller pool is scanned whole by every rank. The resumable slices take
the same engine with the pool's IDF computed once. Rank 0 decides whether
a cache exists, writes caches and the resumable partials, and every rank
reads a written cache back after a barrier, so that all ranks hold the
same neighbours.
"""

import glob
import json
import logging
import os
import re
import shutil
import time

import numpy as np

from .. import tracing
from ..parallel.distributed import from_rank0, on_rank0
from ..retrieval.bm25 import RetrievalResults, _compute_idf_tables, bm25_topk_retrieval
from ..retrieval.sharded import sharded_bm25_topk_retrieval
from .io import load_array, save_hdf5_atomic, save_npz_atomic

# queries per checkpointed slice of a resumable precompute: a crash
# costs one slice, not the whole split's scan
_RESUME_SLICE_ROWS = 2_000_000

# pools below this size fit one device's scan; above it, under a mesh,
# the pool is sharded over the mesh's data axis
_SHARDED_POOL_MIN_ROWS = 2_000_000

# the loader's own knobs, not engine kwargs
_LOADER_KEYS = ("resume_base", "resume_slice_rows", "mesh", "sharded_pool_min_rows")

_RETRIEVED = ("indices", "values", "lens")


class _PartialRetrievalStore:
    """Crash-resumable store for a long retrieval precompute: a directory
    ``<cache>.<tag>.partial/`` holding ``indices.npy``, ``values.npy``
    and ``lens.npy`` as preallocated memmaps, and ``cursor.json`` with
    ``{fingerprint, done_rows}``. A slice's arrays are flushed BEFORE
    the cursor is rewritten (atomically), so a crash at any point costs
    at most the in-flight slice (the cursor then understates and that
    slice is scanned again). A cursor with another fingerprint (another
    query count, pool size, topK or column count) is discarded."""

    def __init__(self, path, n_rows, topk, fingerprint):
        self.path = path
        self.fingerprint = fingerprint
        cursor = os.path.join(path, "cursor.json")
        stored = None
        if os.path.exists(cursor):
            with open(cursor) as fh:
                stored = json.load(fh)
        if os.path.isdir(path) and (stored is None
                                    or stored["fingerprint"] != fingerprint):
            logging.info("Discarding stale retrieval partial %s", path)
            shutil.rmtree(path)
            stored = None
        shapes = {"indices": ((n_rows, topk), np.int64),
                  "values": ((n_rows, topk), np.float64),
                  "lens": ((n_rows,), np.int64)}
        if stored is None:
            os.makedirs(path)
            self.arrays = {k: np.lib.format.open_memmap(
                os.path.join(path, k + ".npy"), mode="w+", dtype=dt, shape=shape)
                for k, (shape, dt) in shapes.items()}
            self.arrays["indices"][:] = -1
            self._write_cursor(0)
        else:
            self.arrays = {k: np.lib.format.open_memmap(
                os.path.join(path, k + ".npy"), mode="r+") for k in shapes}
        self.done_rows = 0 if stored is None else int(stored["done_rows"])

    def _write_cursor(self, done_rows):
        for arr in self.arrays.values():
            arr.flush()                  # data durable before the cursor
        tmp = os.path.join(self.path, "cursor.json.tmp")
        with open(tmp, "w") as fh:
            json.dump({"fingerprint": self.fingerprint, "done_rows": done_rows}, fh)
        os.replace(tmp, os.path.join(self.path, "cursor.json"))

    def append(self, lo, res):
        hi = lo + len(res.lens)
        self.arrays["indices"][lo:hi] = res.indices
        self.arrays["values"][lo:hi] = res.values
        self.arrays["lens"][lo:hi] = res.lens
        self._write_cursor(hi)
        self.done_rows = hi

    def results(self):
        return RetrievalResults(np.array(self.arrays["values"]),
                                np.array(self.arrays["indices"]),
                                np.array(self.arrays["lens"]))


class _PeerStore:
    """What a rank other than 0 keeps of a resumable precompute: the
    cursor rank 0 read, and nothing else. Its results are placeholders:
    the rank reads the cache rank 0 writes."""

    def __init__(self, n_rows, topk, done_rows):
        self.n_rows, self.topk, self.done_rows = n_rows, topk, done_rows

    def append(self, lo, res):
        self.done_rows = lo + len(res.lens)

    def results(self):
        return RetrievalResults(np.zeros((self.n_rows, self.topk)),
                                np.full((self.n_rows, self.topk), -1, dtype=np.int64),
                                np.zeros(self.n_rows, dtype=np.int64))


def _cleanup_partials(resume_base):
    for p in glob.glob(glob.escape(resume_base) + ".*.partial"):
        shutil.rmtree(p)


def _retrieve(db_np_data, qry_np_data, retrieval_configs, resume_tag=None,
              device=None):
    """Engine dispatch: the pool-sharded scan under a mesh when the pool
    has at least ``sharded_pool_min_rows`` rows (the same results
    either way), else the single-device engine.

    With ``resume_tag`` and a ``resume_base`` path in the configs, query
    sets larger than ``resume_slice_rows`` run as checkpointed slices
    through a _PartialRetrievalStore: a scan killed mid-way resumes from
    its last completed slice instead of from zero. The pool's IDF tables
    are computed once and reused across slices."""
    rc = retrieval_configs
    engine_kwargs = {k: v for k, v in rc.items() if k not in _LOADER_KEYS}
    mesh = rc.get("mesh")
    sharded = mesh is not None and \
        len(db_np_data) >= rc.get("sharded_pool_min_rows", _SHARDED_POOL_MIN_ROWS)

    def run(qry, **extra):
        if sharded:
            logging.info("Sharded BM25 pool scan over mesh %s (%d rows%s)", mesh.shape,
                         len(db_np_data), ", dense exact-match mask"
                         if rc.get("exact_match_col_indices") else "")
            return sharded_bm25_topk_retrieval(db_np_data, qry, mesh,
                                               **engine_kwargs, **extra)
        return bm25_topk_retrieval(db_np_data=db_np_data, qry_np_data=qry,
                                   device=device, **engine_kwargs, **extra)

    Q = len(qry_np_data)
    resume_base = rc.get("resume_base")
    slice_rows = int(rc.get("resume_slice_rows", _RESUME_SLICE_ROWS))
    if resume_base is None or resume_tag is None or Q <= slice_rows:
        return run(qry_np_data)

    topk = engine_kwargs.get("topK", 10)
    ncols = qry_np_data.shape[1] if qry_np_data.ndim > 1 else 0
    # slice_rows is deliberately NOT part of the fingerprint: done_rows
    # is a row cursor, so a partial written under one slice size resumes
    # correctly under any other
    fingerprint = "{}:{}:{}:{}".format(Q, len(db_np_data), topk, ncols)
    path = "{}.{}.partial".format(resume_base, resume_tag)
    if mesh is None or mesh.rank == 0:
        store = _PartialRetrievalStore(path, Q, topk, fingerprint)
    if mesh is not None:
        done = from_rank0(mesh, lambda: store.done_rows)
        if mesh.rank != 0:
            store = _PeerStore(Q, topk, done)
    if store.done_rows:
        logging.info("Resuming retrieval '%s' at %d/%d queries",
                     resume_tag, store.done_rows, Q)
    extra = {}
    if not engine_kwargs.get("exact_match_col_indices") \
            and engine_kwargs.get("idf_tables") is None:
        # pool statistics are slice-invariant: one pass here instead of
        # one per slice
        weighting = engine_kwargs.get("idf_weighting") or (
            "robertson" if engine_kwargs.get("generation", 4) == 1 else "lucene")
        with tracing.span("bm25.idf"):
            extra["idf_tables"] = _compute_idf_tables(
                np.ascontiguousarray(db_np_data, dtype=np.int64), weighting)
    for lo in range(store.done_rows, Q, slice_rows):
        hi = min(lo + slice_rows, Q)
        store.append(lo, run(qry_np_data[lo:hi], **extra))
    # the partial survives until the caller's final cache write, so a
    # crash in between still resumes for free
    return store.results()


def _sub_pool_rows(pool_rows, sub_indices, indices):
    """A label-wise sub-pool's neighbour ids as ids of the pool rows
    ``pool_rows``. A -1 (dropped) neighbour maps through the sub-pool's
    last row, as in the JAX package; an empty sub-pool, where the JAX
    package's lookup fails, matches nothing and stays -1."""
    if len(sub_indices) == 0:
        return indices
    return pool_rows[sub_indices[indices]]


def _fold_self_retrieval(data_array, retrieval_configs, device=None):
    """X-fold self-retrieval."""
    used_cols = retrieval_configs["used_col_indices"]
    retrieval_data_array = data_array[:, used_cols].astype(int)
    label_wise = retrieval_configs.get("label_wise", False)
    if label_wise:
        retrieval_db_labels = data_array[:, -1].astype(int)
    retrieved_indices, retrieved_values, retrieved_lens = [], [], []
    fold_num = int(re.match(r"\d+-fold",
                            retrieval_configs["split_type"]).group().split("-")[0])
    fold_size = int(np.ceil(len(retrieval_data_array) / fold_num))
    for fi in range(fold_num):
        with tracing.span("retrieval.fold"):
            logging.info(f"{fold_num}-fold retrieval: process the {fi}-th fold")
            with tracing.span("retrieval.fold_pool"):
                fold_qry_data = retrieval_data_array[fi * fold_size: (fi + 1) * fold_size]
                fold_db_data = np.concatenate(
                    [retrieval_data_array[: fi * fold_size],
                     retrieval_data_array[(fi + 1) * fold_size:]], axis=0)
                fold_db_indices = np.concatenate(
                    [np.arange(fi * fold_size),
                     np.arange((fi + 1) * fold_size, len(retrieval_data_array))], axis=0)
                if label_wise:
                    fold_db_labels = np.concatenate(
                        [retrieval_db_labels[: fi * fold_size],
                         retrieval_db_labels[(fi + 1) * fold_size:]], axis=0)
            if label_wise:
                parts_i, parts_v, parts_l = [], [], []
                for sub, sub_indices in (("pos", np.nonzero(fold_db_labels)[0]),
                                         ("neg", np.nonzero(1 - fold_db_labels)[0])):
                    res = _retrieve(fold_db_data[sub_indices], fold_qry_data,
                                    retrieval_configs,
                                    resume_tag="fold{}.{}".format(fi, sub), device=device)
                    with tracing.span("retrieval.remap"):
                        parts_i.append(_sub_pool_rows(fold_db_indices, sub_indices,
                                                      res.indices))
                    parts_v.append(res.values)
                    parts_l.append(res.lens)
                with tracing.span("retrieval.remap"):
                    retrieved_indices.append(np.concatenate(parts_i, axis=-1))  # Bx(2K)
                    retrieved_values.append(np.concatenate(parts_v, axis=-1))   # Bx(2K)
                    retrieved_lens.append(np.stack(parts_l, axis=-1))           # Bx2
            else:
                res = _retrieve(fold_db_data, fold_qry_data, retrieval_configs,
                                resume_tag="fold{}".format(fi), device=device)
                with tracing.span("retrieval.remap"):
                    retrieved_indices.append(fold_db_indices[res.indices])
                    retrieved_values.append(res.values)
                    retrieved_lens.append(res.lens)
    return (np.concatenate(retrieved_indices),
            np.concatenate(retrieved_values),
            np.concatenate(retrieved_lens))


def _pool_retrieval(data_array, db_array, retrieval_configs, device=None):
    """Retrieval of split queries against an external pool."""
    used_cols = retrieval_configs["used_col_indices"]
    with tracing.span("retrieval.fold_pool"):
        db_data = db_array[:, used_cols].astype(int)
        qry_data = data_array[:, used_cols].astype(int)
    if retrieval_configs.get("label_wise", False):
        db_labels = db_array[:, -1].astype(int)
        parts_i, parts_v, parts_l = [], [], []
        for sub, sub_indices in (("pos", np.nonzero(db_labels)[0]),
                                 ("neg", np.nonzero(1 - db_labels)[0])):
            res = _retrieve(db_data[sub_indices], qry_data, retrieval_configs,
                            resume_tag="pool." + sub, device=device)
            with tracing.span("retrieval.remap"):
                parts_i.append(_sub_pool_rows(np.arange(len(db_labels)), sub_indices,
                                              res.indices))
            parts_v.append(res.values)
            parts_l.append(res.lens)
        with tracing.span("retrieval.remap"):
            return (np.concatenate(parts_i, axis=-1),
                    np.concatenate(parts_v, axis=-1),
                    np.stack(parts_l, axis=-1))
    res = _retrieve(db_data, qry_data, retrieval_configs, resume_tag="pool",
                    device=device)
    return res.indices, res.values, res.lens


def retrieval_cache_path(split_path, topk, tag=""):
    """Where a split's retrieval results are cached: beside the split,
    ``retrieval_{tag}{topk}_<stem>.npz`` for a ``.npy`` split and the JAX
    package's ``retrieval_{tag}{topk}_<name>.h5`` for an ``.h5`` split."""
    data_root, data_fname = os.path.split(split_path)
    if data_fname.endswith(".npy"):
        data_fname = data_fname[:-len(".npy")] + ".npz"
    return os.path.join(data_root, "retrieval_{}{}_{}".format(tag, topk, data_fname))


def save_retrieval_cache(arrays, cache):
    """Write a dict of retrieval arrays in the cache's container."""
    save = save_hdf5_atomic if cache.endswith(".h5") else save_npz_atomic
    save(arrays, cache)


def count_positives(darray):
    """Label sum of a [N, F+1] split, or of the target rows of a
    [N, 1+K, F+1] one."""
    if darray.ndim == 2:
        return darray[:, -1].sum()
    if darray.ndim == 3:
        return darray[:, 0, -1].sum()
    raise ValueError("data_array must be [Nx(F+1)] or [Nx(K+1)x(F+1)]")


class SplitBatches(object):
    """What the trainer reads of a split loaded in memory (a
    DataGenerator, or one block view of a DataBlockGenerator): rows
    ``darray``, the neighbours' pool ``pool_darray`` and ids
    ``retr_indices``, and batches of ``batch_size`` row ids. The -1
    padded neighbor index wraps to the pool's LAST row, as in the
    reference; ``neighbor_gather_indices`` makes that wrap explicit."""

    @property
    def topk(self):
        return 0 if self.retr_indices is None else self.retr_indices.shape[-1]

    def neighbor_gather_indices(self):
        """Neighbor row ids with the reference's -1 -> last-row wrap."""
        n_pool = len(self.pool_darray)
        return np.where(self.retr_indices < 0,
                        self.retr_indices + n_pool,
                        self.retr_indices).astype(np.int64)

    def neighbor_valid_mask(self):
        """[N, K] float32: 1 = real neighbor, 0 = dropped zero-score slot."""
        return (self.retr_indices >= 0).astype(np.float32)

    def epoch_index_batches(self, rng=None):
        """Yield (row_indices [B], valid_count) per step; the final
        partial batch is padded by repeating index 0 and cut by
        ``valid``."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            (rng or np.random).shuffle(order)
        for start in range(0, self.num_samples, self.batch_size):
            batch = order[start:start + self.batch_size]
            valid = len(batch)
            if valid < self.batch_size:
                batch = np.concatenate(
                    [batch, np.zeros(self.batch_size - valid, dtype=batch.dtype)])
            yield batch.astype(np.int64), valid

    def __len__(self):
        return self.num_batches


class DataGenerator(SplitBatches):
    """One split: data array + (optional) neighbor retrieval.

    Built either from split files (``data_path``: ``.npy`` from the
    port's build or the JAX package's ``.h5``, with the pool file named
    by ``retrieval_pool_fname``) or from arrays already in memory
    (``data_array`` and, for a pool other than "self", ``pool_array``),
    which writes no retrieval cache.
    """

    def __init__(self, data_path=None, batch_size=32, shuffle=False,
                 feature_map=None,
                 retrieval_configs=None,
                 retrieval_pool_fname=None,
                 retrieval_augmented=False,
                 data_array=None,
                 pool_array=None,
                 device=None,
                 **kwargs):
        if data_array is None:
            data_paths = data_path if isinstance(data_path, list) else [data_path]
            arrays = [load_array(p) for p in data_paths]
            data_array = arrays[0] if len(arrays) == 1 \
                else np.concatenate(arrays, axis=0)
        else:
            data_paths = None
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.feature_map = feature_map
        self.retrieval_augmented = False
        self.darray = data_array
        self.pool_darray = None
        self.retrieval_pool_fname = retrieval_pool_fname
        self.retr_indices = None
        self.retr_values = None
        self.retr_lens = None
        #: seconds spent retrieving the split's neighbours (or reading
        #: them from the cache)
        self.retrieval_s = 0.0

        if retrieval_configs is not None:
            t0 = time.perf_counter()
            if not retrieval_configs.get("pre_retrieval", True):
                raise NotImplementedError(
                    "only the pre-retrieval strategy is implemented")
            db_array = pool_array
            if db_array is None and retrieval_pool_fname != "self":
                logging.info(f"{retrieval_configs['split_type']} retrieval, "
                             f"pool file: {retrieval_pool_fname}")
                db_array = load_array(retrieval_pool_fname)
            cache = None if data_paths is None \
                else retrieval_cache_path(data_paths[0], retrieval_configs["topK"])
            mesh = retrieval_configs.get("mesh")
            if cache is not None and from_rank0(mesh, lambda: os.path.exists(cache)):
                retrieved = tuple(load_array(cache, key) for key in _RETRIEVED)
            else:
                # resume_base switches long scans to checkpointed slices
                # keyed off the final cache path
                rc = dict(retrieval_configs, resume_base=cache)
                if db_array is None:
                    retrieved = _fold_self_retrieval(data_array, rc, device)
                else:
                    retrieved = _pool_retrieval(data_array, db_array, rc, device)
                if cache is not None:
                    def write():
                        save_retrieval_cache(dict(zip(_RETRIEVED, retrieved)), cache)
                        _cleanup_partials(cache)
                    on_rank0(mesh, write)
                    if mesh is not None:
                        retrieved = tuple(load_array(cache, key) for key in _RETRIEVED)
            retrieved_indices, retrieved_values, retrieved_lens = retrieved
            self.retrieval_s = time.perf_counter() - t0
            if retrieval_augmented:
                self.retrieval_augmented = True
                self.pool_darray = data_array if db_array is None else db_array
                self.retr_indices = retrieved_indices.astype(np.int64)
                self.retr_values = retrieved_values
                self.retr_lens = retrieved_lens
                if not len(self.darray) == len(self.retr_indices) == \
                        len(self.retr_values) == len(self.retr_lens):
                    raise ValueError("retrieval results do not match the split")
            else:
                logging.info("[[WARNING]] dataloader provided retrieved samples but "
                             "the model doesn't enable retrieval-augmented mode.")
        elif retrieval_augmented:
            raise ValueError("retrieval-augmented mode requires a dataset with "
                             "retrieval configs")

        self.num_blocks = 1
        self.num_samples = len(self.darray)
        self.num_batches = int(np.ceil(self.num_samples * 1.0 / self.batch_size))
        self.num_positives = count_positives(self.darray)
        self.num_negatives = self.num_samples - self.num_positives


def get_data_generator(data_path_list, batch_size=32, shuffle=False,
                       feature_map=None, retrieval_configs=None,
                       retrieval_pool_fname=None, retrieval_augmented=False,
                       **kwargs):
    """One block -> DataGenerator (the whole split on the device); more
    -> the streaming DataBlockGenerator with per-block retrieval caches,
    which keeps the whole-split and per-block caches apart."""
    if len(data_path_list) == 0:
        raise ValueError("invalid data files or paths.")
    if len(data_path_list) > 1:
        from .block_loader import DataBlockGenerator
        return DataBlockGenerator(data_block_list=data_path_list,
                                  batch_size=batch_size,
                                  shuffle=shuffle,
                                  feature_map=feature_map,
                                  retrieval_configs=retrieval_configs,
                                  retrieval_pool_fname=retrieval_pool_fname,
                                  retrieval_augmented=retrieval_augmented,
                                  **kwargs)
    return DataGenerator(data_path=data_path_list,
                         batch_size=batch_size,
                         shuffle=shuffle,
                         feature_map=feature_map,
                         retrieval_configs=retrieval_configs,
                         retrieval_pool_fname=retrieval_pool_fname,
                         retrieval_augmented=retrieval_augmented,
                         **kwargs)


def tfrecord_generator():
    """API-parity stub, as in the JAX package and the reference."""
    raise NotImplementedError()


def h5_generator(feature_map, stage="both", train_data=None, valid_data=None,
                 test_data=None, batch_size=32, shuffle=True,
                 retrieval_configs=None, retrieval_augmented=False, **kwargs):
    """Stage-aware generator factory: resolves retrieval column names to
    indices and picks the retrieval pool per split (X-fold: train pool =
    'self', valid/test pool = first train block). ``kwargs`` (e.g.
    ``device``) pass through to DataGenerator."""
    logging.info("Loading data...")
    if retrieval_configs is not None:
        retrieval_configs["used_col_indices"] = [
            feature_map.feature_specs[col]["index"]
            for col in retrieval_configs["used_cols"]]
        exact_match_col_indices = None
        if len(retrieval_configs.get("exact_match_cols", []) or []) > 0:
            exact_match_col_indices = [retrieval_configs["used_cols"].index(item)
                                       for item in retrieval_configs["exact_match_cols"]]
        retrieval_configs["exact_match_col_indices"] = exact_match_col_indices

    def _sorted_blocks(pattern):
        blocks = glob.glob(pattern)
        if len(blocks) > 1:
            blocks.sort(key=lambda x: int(x.split("_")[-1].split(".")[0]))
        return blocks

    def _pools():
        if retrieval_configs is None:
            return None, None
        if re.match(r"\d+-fold", retrieval_configs["split_type"]) is not None:
            return "self", _sorted_blocks(train_data)[0]
        pool = retrieval_configs["retrieval_pool_data"]
        return pool, pool

    def _log(name, gen):
        logging.info("{} samples: total/{:d}, pos/{:.0f}, neg/{:.0f}, "
                     "ratio/{:.2f}%, blocks/{:.0f}".format(
                         name, gen.num_samples, gen.num_positives,
                         gen.num_negatives,
                         100. * gen.num_positives / gen.num_samples,
                         gen.num_blocks))

    common = dict(batch_size=batch_size, feature_map=feature_map,
                  retrieval_configs=retrieval_configs,
                  retrieval_augmented=retrieval_augmented, **kwargs)
    train_gen = valid_gen = test_gen = None
    if stage in ["both", "train"]:
        train_blocks = _sorted_blocks(train_data)
        valid_blocks = _sorted_blocks(valid_data)
        if not train_blocks or not valid_blocks:
            raise ValueError("invalid data files or paths.")
        train_pool, valid_pool = _pools()
        train_gen = get_data_generator(train_blocks, shuffle=shuffle,
                                       retrieval_pool_fname=train_pool, **common)
        valid_gen = get_data_generator(valid_blocks, shuffle=False,
                                       retrieval_pool_fname=valid_pool, **common)
        _log("Train", train_gen)
        _log("Validation", valid_gen)
        if stage == "train":
            logging.info("Loading train data done.")
            return train_gen, valid_gen

    if stage in ["both", "test"]:
        test_blocks = _sorted_blocks(test_data) if test_data else []
        if len(test_blocks) > 0:
            test_gen = get_data_generator(test_blocks, shuffle=False,
                                          retrieval_pool_fname=_pools()[1],
                                          **common)
            _log("Test", test_gen)
        if stage == "test":
            logging.info("Loading test data done.")
            return test_gen

    logging.info("Loading data done.")
    return train_gen, valid_gen, test_gen
