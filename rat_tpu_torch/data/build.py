"""CSV -> encoded ``.npy`` dataset build (port of rat_tpu.data.build).

Orchestrates the one-time host-side encode: read each CSV split, carve
valid/test (and optionally a retrieval pool) out of the training rows,
fit the feature encoder, then stream every split through ``transform``
into ``<data_dir>/<split>.npy`` (or ``<split>_part_N.npy`` chunks when
``data_block_size`` is set). The arrays are the JAX package's ``.h5``
datasets, in numpy's own container.

Semantics, as in the JAX package:
  * split sizes may be absolute counts or fractions of the ORIGINAL row
    count; under ``random`` the row order is shuffled with the global
    numpy RNG (``seed_everything`` seeds it); test is carved from the
    tail first, then valid from the new tail, and every produced split
    keeps its original row ids in an ``index`` column;
  * retrieval pools come from an explicit ``retrieval_pool_data`` file
    (encoder fit on train+pool), or from a ``pool_ratio`` carve of the
    train rows (the LEADING ``pool_ratio`` fraction becomes the pool,
    the tail stays train) — except under an ``N-fold`` split type,
    where retrieval is self-service and no pool artifact is written;
  * write order is train, retrieval_pool, valid, test, each encoded
    array freed before the next so peak memory stays one split.

``build_dataset`` returns the seconds of its four stages: ``csv_read``
(reading the CSVs and the per-column preprocess hooks), ``fit`` (the
valid/test and pool carves and the vocabulary fit), ``transform``
(encoding every split) and ``npy_write``.
"""

import gc
import logging
import os
import re
import time
from collections import OrderedDict

import numpy as np

from ..features import csv_table
from .io import save_npy_atomic

logger = logging.getLogger(__name__)

_FOLD_SPLIT = re.compile(r"\d+-fold")


def _resolve_count(total, size):
    """A split size below 1 is a fraction of ``total``; else a count."""
    return int(total * size) if size < 1 else int(size)


def split_train_test(train_ddf=None, valid_ddf=None, test_ddf=None, valid_size=0,
                     test_size=0, split_type="sequential"):
    """Carve valid/test splits off the tail of ``train_ddf`` (a
    csv_table dict).

    After the optional shuffle the row order reads ``[train | valid |
    test]``; both carve sizes are resolved against the original row
    count. Requested-but-empty carves still produce (empty) tables, and
    any carve re-takes the train rows too.
    """
    total = csv_table.num_rows(train_ddf)
    order = np.arange(total)
    if split_type == "random":
        np.random.shuffle(order)

    want_test = test_size > 0
    want_valid = valid_size > 0
    n_test = _resolve_count(total, test_size) if want_test else 0
    n_valid = _resolve_count(total, valid_size) if want_valid else 0

    if want_test:
        test_ddf = csv_table.take(train_ddf, order[total - n_test:])
    if want_valid:
        lo, hi = total - n_test - n_valid, total - n_test
        valid_ddf = csv_table.take(train_ddf, order[lo:hi])
    if want_test or want_valid:
        train_ddf = csv_table.take(train_ddf, order[:total - n_test - n_valid])
    return train_ddf, valid_ddf, test_ddf


def _read_split(feature_encoder, path):
    return feature_encoder.preprocess(feature_encoder.read_csv(path)) if path else None


def _write_encoded(table, data_dir, split, block_rows):
    """One .npy per split, or fixed-size ``_part_N`` chunks when
    blocked."""
    if block_rows > 0:
        for part, start in enumerate(range(0, len(table), block_rows)):
            save_npy_atomic(table[start:start + block_rows, :],
                            os.path.join(data_dir, "{}_part_{}.npy".format(split, part)))
    else:
        save_npy_atomic(table, os.path.join(data_dir, "{}.npy".format(split)))


def build_dataset(feature_encoder, train_data=None, valid_data=None, test_data=None,
                  valid_size=0, test_size=0, split_type="sequential",
                  retrieval_configs=None, **kwargs):
    """Fit the feature map and encode every CSV split to .npy. Returns
    {stage: seconds} for csv_read, fit, transform and npy_write."""
    seconds = dict.fromkeys(("csv_read", "fit", "transform", "npy_write"), 0.0)
    t0 = time.perf_counter()
    train_ddf = _read_split(feature_encoder, train_data)
    valid_ddf = _read_split(feature_encoder, valid_data)
    test_ddf = _read_split(feature_encoder, test_data)
    pool_ddf = _read_split(feature_encoder,
                           (retrieval_configs or {}).get("retrieval_pool_data"))
    seconds["csv_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if valid_size > 0 or test_size > 0:
        train_ddf, valid_ddf, test_ddf = split_train_test(
            train_ddf, valid_ddf, test_ddf, valid_size, test_size, split_type)

    # Fit the encoder and settle where the retrieval pool comes from.
    if retrieval_configs is None:
        feature_encoder.fit(train_ddf, **kwargs)
    elif "retrieval_pool_data" in retrieval_configs:
        feature_encoder.fit(csv_table.concat([train_ddf, pool_ddf]), **kwargs)
    else:
        if "pool_ratio" not in retrieval_configs or \
                "split_type" not in retrieval_configs:
            raise ValueError("retrieval_configs need pool_ratio and split_type "
                             "without a retrieval_pool_data file")
        feature_encoder.fit(train_ddf, **kwargs)
        if _FOLD_SPLIT.match(retrieval_configs["split_type"]) is None:
            # split_train_test hands back (leading, tail, _): the leading
            # pool_ratio fraction is the pool, the tail stays as train.
            pool_ddf, train_ddf, _ = split_train_test(
                train_ddf=train_ddf,
                valid_size=1 - retrieval_configs["pool_ratio"],
                split_type=retrieval_configs["split_type"])

    seconds["fit"] = time.perf_counter() - t0

    # N-fold self-retrieval needs no pool artifact on disk.
    keep_pool = (retrieval_configs is not None and
                 _FOLD_SPLIT.match(retrieval_configs["split_type"]) is None)

    pending = OrderedDict()
    pending["train"] = train_ddf
    if keep_pool:
        pending["retrieval_pool"] = pool_ddf
    for split, ddf in (("valid", valid_ddf), ("test", test_ddf)):
        if ddf is not None:
            pending[split] = ddf
    del train_ddf, valid_ddf, test_ddf, pool_ddf

    block_rows = int(kwargs.get("data_block_size", 0))
    while pending:
        split, ddf = pending.popitem(last=False)
        t0 = time.perf_counter()
        table = feature_encoder.transform(ddf)
        del ddf
        t1 = time.perf_counter()
        _write_encoded(table, feature_encoder.data_dir, split, block_rows)
        seconds["transform"] += t1 - t0
        seconds["npy_write"] += time.perf_counter() - t1
        del table
        gc.collect()
    logger.info("Encoded all CSV splits to .npy under %s", feature_encoder.data_dir)
    return seconds
