"""The numbers by which the program's outputs are held to the reference.
Each is 0 for an answer equal to the reference's, and grows with the
departure; the harness compares each with its limit."""

import numpy as np
import torch

from .bm25 import row_scores

#: the gap given to an answer that is no answer at all: a row from the
#: query's own fold, a row named twice, a dropped slot that names the
#: wrong row, a live slot dropped
WRONG = 1e6


def neighbour_gap(ref, pool, prog_rows, prog_scores=None):
    """The widest gap, in IDF units, between the reference's K best
    scores and the scores of the rows the program returned (and the
    scores it reported, when given), slot by slot. Rows of equal score
    are equally right, so ties may fall either way; ``ref`` is
    :meth:`Retrieval.run`'s dict, ``pool`` [N, F] the pool's ids."""
    v, dropped, ex = ref["scores"], ref["dropped"], ref["excluded"]
    live = v > 0
    got = row_scores(ref["q"], ref["q_idf"], prog_rows, pool)
    gap = torch.where(live, (got - v).abs(), torch.zeros_like(v))
    if prog_scores is not None:
        gap = torch.maximum(gap, (prog_scores.to(torch.float32) - v).abs())
    own = (prog_rows >= ex[:, :1]) & (prog_rows < ex[:, 1:])
    bad = (live & ((prog_rows < 0) | own)) | (~live & (prog_rows != dropped[:, None]))
    marked = torch.where(live, prog_rows, -1 - torch.arange(
        v.shape[1], device=v.device)[None, :].expand_as(prog_rows))
    ordered = torch.sort(marked, dim=1).values
    twice = (ordered[:, 1:] == ordered[:, :-1]).any(dim=1, keepdim=True)
    gap = torch.where(bad | twice, torch.full_like(gap, WRONG), gap)
    return float(gap.max()) if gap.numel() else 0.0


def relative_gap(got, want):
    """max |got - want| / |want| over paired sequences."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def leaf_gap(got, want, leaves=None):
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and
    the median leaf's. ``got`` and ``want`` map leaf names to norms; a
    leaf the program lacks reads 0; ``leaves`` limits the leaves."""
    names = sorted(want if leaves is None else leaves)
    ref = np.array([want[n] for n in names], np.float64)
    prog = np.array([got.get(n, 0.0) for n in names], np.float64)
    scale = np.maximum(ref, np.median(ref))
    return float(np.max(np.abs(prog - ref) / scale))


def moving_leaves(grad_norms, share=1e-3):
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others (a dead parameter, a term zero to rounding)
    move under Adam by round-off alone and are left out of the change."""
    median = float(np.median(list(grad_norms.values())))
    return [n for n, g in grad_norms.items() if g >= share * median]


def prediction_gap(got, want):
    """The widest gap between the program's predicted click probability
    and the reference's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) if got.size else 0.0
