"""What the runners share: the grid rows that the reference reads for a
set of rows and their neighbours, the neighbour answer of the reference
as the program gives it, and freeing the program's state before the
reference runs."""

import gc

import numpy as np
import torch

from ..reference import bm25 as ref_bm25
from ..reference import judge

#: the precision one step below the configurations' float32
CONTROL_DTYPE = torch.bfloat16


def grid_inputs(rows, neighbours, split, pool, device):
    """(ids [R, 1 + K, F] int64, labels [R, 1 + K] float32) on the device:
    each row of ``split`` followed by its neighbours' rows of ``pool``; a
    dropped neighbour (-1) takes the pool's last row."""
    nb = np.where(neighbours < 0, neighbours + len(pool), neighbours)
    full = np.concatenate([split[rows][:, None, :], pool[nb]], axis=1)
    ids = torch.from_numpy(full[..., :-1].astype(np.int64)).to(device)
    labels = torch.from_numpy(full[..., -1].astype(np.float32)).to(device)
    return ids, labels


def answer(ref):
    """The reference's rows as the program reports them: a dropped slot
    (score 0) names the row the retrieval puts there."""
    return torch.where(ref["scores"] > 0, ref["rows"], ref["dropped"][:, None])


def control_neighbours(retrieval, rows):
    """(the neighbour gap of the reference's retrieval summed in the
    control's precision, its rows as a host array)."""
    want = retrieval.run(rows)
    low = retrieval.run(rows, dtype=CONTROL_DTYPE)
    got = answer(low)
    return judge.neighbour_gap(want, retrieval.db, got), got.cpu().numpy()


def quartiles(ends, start):
    """[min, first quartile, median, third quartile, max] of the times
    between consecutive ``ends`` (from ``start``): how steady a window's
    units of work were."""
    d = np.diff(np.concatenate([[start], ends]))
    return [float(x) for x in np.percentile(d, [0, 25, 50, 75, 100])]


def free(run):
    """Drop the program's state and return its device memory, so that
    the reference runs in what the program held."""
    run.trainer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(n, k, seed):
    """``k`` distinct row ids of ``n``, drawn from ``seed``, in order."""
    return np.sort(np.random.RandomState(seed).choice(n, min(k, n), replace=False))


def vocab_rows(vocab):
    """The id space of every field: one past the largest vocabulary."""
    return max(vocab.values())


def retrieval(cfg, split, vocab, device, pool=None):
    """The reference's retrieval over ``split`` (X-fold) or against
    ``pool``, as the configuration's retrieval block states it."""
    rc = cfg["dataset"]["retrieval"]
    names = list(cfg["dataset"]["fields"])
    cols = [names.index(c) for c in rc["used_cols"]]
    return ref_bm25.Retrieval(split, cols, rc, vocab_rows(vocab), device, pool=pool)
