"""BM25 top-K over categorical id rows, as the RAT method retrieves
neighbours (the reference's fuxictr BM25 on ids):

- IDF per field over the pool: ``log(N / count)`` in float64, cast to
  float32; 0 for a value the pool lacks;
- score of a pool row = sum over fields, in field order, of
  ``1[query == row] * IDF(query value)``, in float32;
- the K rows of highest score, ties to the lower pool position; a slot
  whose score is 0 is dropped.

X-fold self-retrieval: the split is cut into X contiguous folds of
``ceil(n / X)`` rows, and each fold's rows query the rows of the other
folds, whose counts make the IDF. A dropped slot then names the last row
of the query's pool, and in a retrieval against another split's pool it
names no row (-1), which the model reads as the pool's last row.
"""

import math

import numpy as np
import torch

#: queries scored against the whole pool at once
CHUNK = 128
_LOW32 = 0xFFFFFFFF


def counts(cols, vocab):
    """[F, V] int64 counts of each id per field of ``cols`` [n, F]."""
    out = np.zeros((cols.shape[1], vocab), np.int64)
    for f in range(cols.shape[1]):
        out[f] = np.bincount(cols[:, f], minlength=vocab)
    return out


def idf(field_counts, n_pool):
    """[F, V] float32 IDF from the pool's counts; 0 where a count is 0."""
    with np.errstate(divide="ignore"):
        table = np.log(n_pool / field_counts.astype(np.float64))
    return np.where(field_counts > 0, table, 0.0).astype(np.float32)


def folds(n_rows, split_type):
    """The folds of an X-fold split: [(first row, end row), ...]."""
    x = int(split_type.split("-")[0])
    size = int(math.ceil(n_rows / x))
    return [(fi * size, min(n_rows, (fi + 1) * size)) for fi in range(x)
            if fi * size < n_rows]


def _scores(q, q_idf, pool_t, dtype):
    """[c, N] scores of queries ``q`` [c, F] with IDF ``q_idf`` against
    the field-major pool ``pool_t`` [F, N], summed in field order."""
    s = torch.zeros((q.shape[0], pool_t.shape[1]), dtype=dtype, device=q.device)
    for f in range(q.shape[1]):
        s = s + (q[:, f, None] == pool_t[f][None, :]).to(dtype) * q_idf[:, f, None].to(dtype)
    return s.to(torch.float32)


def topk(queries, query_idf, pool_t, k, excluded=None, dtype=torch.float32):
    """(scores [Q, K] float32, positions [Q, K] int64) of the K best pool
    rows of each query, score first, then the lower position. ``excluded``
    [Q, 2] gives each query a range of positions it may not take (its
    own fold). ``dtype`` is that of the sum (a lower one is the
    control). Scores are non-negative, so their float32 bits order as
    they do, and one int64 key per row (score bits over the complement
    of the position) makes the order total."""
    device = pool_t.device
    n = pool_t.shape[1]
    pos = torch.arange(n, device=device)
    out_v, out_i = [], []
    for lo in range(0, len(queries), CHUNK):
        q = queries[lo:lo + CHUNK]
        s = _scores(q, query_idf[lo:lo + CHUNK], pool_t, dtype)
        key = (s.view(torch.int32).to(torch.int64) << 32) | (_LOW32 - pos)[None, :]
        if excluded is not None:
            ex = excluded[lo:lo + CHUNK]
            out = (pos[None, :] >= ex[:, :1]) & (pos[None, :] < ex[:, 1:])
            key = torch.where(out, torch.full_like(key, -1), key)
        best = torch.topk(key, k, dim=1).values
        out_v.append((best >> 32).to(torch.int32).view(torch.float32))
        out_i.append(_LOW32 - (best & _LOW32))
    return torch.cat(out_v), torch.cat(out_i)


def query_idf(queries, idf_table):
    """[Q, F] IDF of each query value, from ``idf_table`` [F, V]."""
    f = torch.arange(queries.shape[1], device=queries.device)
    return idf_table[f[None, :], queries]


def row_scores(queries, query_idf_, rows, pool):
    """[Q, K] float32 scores of the pool rows ``rows`` [Q, K] (positions
    into ``pool`` [N, F]) for each query, summed in field order."""
    cand = pool[rows.clamp(min=0)]                              # [Q, K, F]
    s = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    for f in range(queries.shape[1]):
        s = s + (cand[..., f] == queries[:, None, f]).to(torch.float32) \
            * query_idf_[:, None, f]
    return s


class Retrieval(object):
    """The reference's neighbours of any rows of a split, from the split
    itself (X-fold) or from another split's rows (``pool``)."""

    def __init__(self, split, cols, retrieval, vocab, device, pool=None):
        """``cols``: the split's columns that retrieval reads; ``retrieval``:
        the dataset's retrieval block; ``vocab``: one past the largest id."""
        self.k = retrieval["topK"]
        self.device = device
        self.split = np.ascontiguousarray(split[:, cols].astype(np.int64))
        self.self_pool = pool is None
        db = self.split if pool is None else \
            np.ascontiguousarray(pool[:, cols].astype(np.int64))
        self.db = torch.from_numpy(db).to(device)
        self.db_t = self.db.t().contiguous()
        self.total = counts(db, vocab)
        self.folds = folds(len(split), retrieval["split_type"]) if pool is None else None

    def _fold(self, rows):
        starts = np.array([lo for lo, _ in self.folds])
        return np.searchsorted(starts, rows, side="right") - 1

    def run(self, rows, dtype=torch.float32):
        """The reference's answer for the split's rows ``rows``, a dict:
        ``scores`` [R, K] float32 and ``rows`` [R, K] int64 (positions in
        the pool), the queries ``q`` [R, F] and their IDF ``q_idf``, the
        row a dropped slot names (``dropped`` [R]) and the positions each
        query may not take (``excluded`` [R, 2]), on the device."""
        q = torch.from_numpy(self.split[rows]).to(self.device)
        if not self.self_pool:
            table = torch.from_numpy(idf(self.total, len(self.db))).to(self.device)
            q_idf = query_idf(q, table)
            v, i = topk(q, q_idf, self.db_t, self.k, dtype=dtype)
            none = torch.zeros((len(rows), 2), dtype=torch.int64, device=self.device)
            return {"scores": v, "rows": i, "q": q, "q_idf": q_idf, "excluded": none,
                    "dropped": torch.full((len(rows),), -1, device=self.device)}
        fold_of = self._fold(rows)
        q_idf = torch.empty(q.shape, dtype=torch.float32, device=self.device)
        excluded = np.zeros((len(rows), 2), np.int64)
        dropped = np.zeros(len(rows), np.int64)
        n = len(self.split)
        for fi in np.unique(fold_of):
            lo, hi = self.folds[fi]
            mine = fold_of == fi
            table = idf(self.total - counts(self.split[lo:hi], self.total.shape[1]),
                        n - (hi - lo))
            sel = torch.from_numpy(np.nonzero(mine)[0]).to(self.device)
            q_idf[sel] = query_idf(q[sel], torch.from_numpy(table).to(self.device))
            excluded[mine] = (lo, hi)
            dropped[mine] = n - 1 if hi < n else lo - 1
        excluded = torch.from_numpy(excluded).to(self.device)
        v, i = topk(q, q_idf, self.db_t, self.k, excluded=excluded, dtype=dtype)
        return {"scores": v, "rows": i, "q": q, "q_idf": q_idf, "excluded": excluded,
                "dropped": torch.from_numpy(dropped).to(self.device)}
