"""Data loading runtime: splits + retrieval precompute + index batching
(port of rat_tpu.data.loader, single device).

Retrieval precompute keeps the reference's semantics:

- X-fold self-retrieval: split the split's own rows into contiguous
  folds; queries = fold i, pool = all other folds; map local -> global;
- pool retrieval: split queries against an external pool (valid/test
  against the first train block under X-fold);
- label_wise: separate pos-pool and neg-pool retrievals concatenated to
  2K neighbors;
- results cached to ``retrieval_{topK}_<fname>.h5`` with keys
  indices/values/lens (the JAX package's artifact format).

Not ported yet: the mesh-sharded scan, the resumable partial store and
block streaming (DataBlockGenerator).
"""

import glob
import logging
import os
import re

import numpy as np

from ..retrieval.bm25 import bm25_topk_retrieval
from .io import load_hdf5, save_hdf5_atomic


def _retrieve(db_np_data, qry_np_data, retrieval_configs, device=None):
    """Single-device engine dispatch."""
    return bm25_topk_retrieval(db_np_data=db_np_data, qry_np_data=qry_np_data,
                               device=device, **retrieval_configs)


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
        logging.info(f"{fold_num}-fold retrieval: process the {fi}-th fold")
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
            parts_i, parts_v, parts_l = [], [], []
            for sub_indices in (np.nonzero(fold_db_labels)[0],
                                np.nonzero(1 - fold_db_labels)[0]):
                res = _retrieve(fold_db_data[sub_indices], fold_qry_data,
                                retrieval_configs, device)
                parts_i.append(fold_db_indices[sub_indices[res.indices]])
                parts_v.append(res.values)
                parts_l.append(res.lens)
            retrieved_indices.append(np.concatenate(parts_i, axis=-1))  # Bx(2K)
            retrieved_values.append(np.concatenate(parts_v, axis=-1))   # Bx(2K)
            retrieved_lens.append(np.stack(parts_l, axis=-1))           # Bx2
        else:
            res = _retrieve(fold_db_data, fold_qry_data, retrieval_configs, device)
            retrieved_indices.append(fold_db_indices[res.indices])
            retrieved_values.append(res.values)
            retrieved_lens.append(res.lens)
    return (np.concatenate(retrieved_indices),
            np.concatenate(retrieved_values),
            np.concatenate(retrieved_lens))


def _pool_retrieval(data_array, db_array, retrieval_configs, device=None):
    """Retrieval of split queries against an external pool."""
    used_cols = retrieval_configs["used_col_indices"]
    db_data = db_array[:, used_cols].astype(int)
    qry_data = data_array[:, used_cols].astype(int)
    if retrieval_configs.get("label_wise", False):
        db_labels = db_array[:, -1].astype(int)
        parts_i, parts_v, parts_l = [], [], []
        for sub_indices in (np.nonzero(db_labels)[0], np.nonzero(1 - db_labels)[0]):
            res = _retrieve(db_data[sub_indices], qry_data, retrieval_configs,
                            device)
            parts_i.append(sub_indices[res.indices])
            parts_v.append(res.values)
            parts_l.append(res.lens)
        return (np.concatenate(parts_i, axis=-1),
                np.concatenate(parts_v, axis=-1),
                np.stack(parts_l, axis=-1))
    res = _retrieve(db_data, qry_data, retrieval_configs, device)
    return res.indices, res.values, res.lens


class DataGenerator(object):
    """One split: data array + (optional) neighbor retrieval.

    Built either from h5 files (``data_path``, with the pool file named
    by ``retrieval_pool_fname``) or from arrays already in memory
    (``data_array`` and, for a pool other than "self", ``pool_array``),
    which needs no h5py and writes no retrieval cache.

    The -1 padded neighbor index wraps to the pool's LAST row, as in the
    reference; ``neighbor_gather_indices`` makes that wrap explicit.
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
            arrays = [load_hdf5(p) for p in data_paths]
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

        if retrieval_configs is not None:
            if not retrieval_configs.get("pre_retrieval", True):
                raise NotImplementedError(
                    "only the pre-retrieval strategy is implemented")
            db_array = pool_array
            if db_array is None and retrieval_pool_fname != "self":
                logging.info(f"{retrieval_configs['split_type']} retrieval, "
                             f"pool file: {retrieval_pool_fname}")
                db_array = load_hdf5(retrieval_pool_fname)
            cache = None
            if data_paths is not None:
                data_root, data_fname = os.path.split(data_paths[0])
                cache = os.path.join(
                    data_root, f'retrieval_{retrieval_configs["topK"]}_' + data_fname)
            if cache is not None and os.path.exists(cache):
                retrieved = tuple(load_hdf5(cache, key)
                                  for key in ("indices", "values", "lens"))
            elif db_array is None:
                retrieved = _fold_self_retrieval(data_array, retrieval_configs,
                                                 device)
            else:
                retrieved = _pool_retrieval(data_array, db_array,
                                            retrieval_configs, device)
            if cache is not None and not os.path.exists(cache):
                save_hdf5_atomic(dict(zip(("indices", "values", "lens"), retrieved)),
                                 cache)
            retrieved_indices, retrieved_values, retrieved_lens = retrieved
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
        self.num_positives = self.darray[:, -1].sum()
        self.num_negatives = self.num_samples - self.num_positives

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


def get_data_generator(data_path_list, batch_size=32, shuffle=False,
                       feature_map=None, retrieval_configs=None,
                       retrieval_pool_fname=None, retrieval_augmented=False,
                       **kwargs):
    if len(data_path_list) == 0:
        raise ValueError("invalid data files or paths.")
    if len(data_path_list) > 1:
        raise NotImplementedError(
            "multi-block splits need block streaming, not ported yet "
            "(ROADMAP.md, Queue 1 item 8)")
    return DataGenerator(data_path=data_path_list,
                         batch_size=batch_size,
                         shuffle=shuffle,
                         feature_map=feature_map,
                         retrieval_configs=retrieval_configs,
                         retrieval_pool_fname=retrieval_pool_fname,
                         retrieval_augmented=retrieval_augmented,
                         **kwargs)


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
