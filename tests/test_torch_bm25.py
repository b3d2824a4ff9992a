"""BM25 retrieval of the port against the JAX package, exact.

The same integer pools and queries (seeded numpy) go through
rat_tpu_torch's plain K2 (``bm25_topk_reference``) and
``bm25_topk_retrieval(device="cpu")``, and through the JAX package's
``bm25_topk_retrieval`` and its fused Pallas kernel in interpret mode.
Scores are sums of float32 IDF terms added in field order, ties go to
the lowest pool index: values, indices and lens must be EQUAL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.ops.pallas.bm25_scan import bm25_topk_fused_pallas
from rat_tpu.retrieval import bm25 as jbm25
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.retrieval import bm25 as tbm25


def _data(seed, N, Q, F, vocab, lo=0):
    rng = np.random.RandomState(seed)
    db = rng.randint(lo, vocab, (N, F)).astype(np.int64)
    # half the queries are pool rows (many full matches), half fresh
    qry = np.concatenate([db[rng.randint(0, N, Q // 2)],
                          rng.randint(lo, vocab + 3, (Q - Q // 2, F))])
    return db, qry


# name: (N, Q, F, vocab, K, lo)
CASES = {
    "heavy_ties_f3": (3000, 200, 3, 6, 5, 0),
    "pool_not_chunk_multiple_f11": (1237, 150, 11, 40, 7, 0),
    "k_exceeds_pool": (6, 40, 3, 4, 10, 0),
    "negative_ids_searchsorted": (900, 131, 4, 30, 5, -20),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_topk_matches_pallas_interpret(name):
    """Raw (pre-drop) output of the port's plain K2 vs the JAX fused
    kernel in interpret mode, on the same padded field-major pool."""
    N, Q, F, vocab, K, lo = CASES[name]
    db, qry = _data(1, N, Q, F, vocab, lo)
    qidf = jbm25._map_to_idf(qry, jbm25._compute_idf_tables(db))
    bc = 512
    C = max(N, bc) + (-max(N, bc)) % bc
    dbT = np.zeros((F, C), np.int32)
    dbT[:, :N] = db.T
    v1, i1 = bm25_topk_fused_pallas(jnp.asarray(qry, jnp.int32), jnp.asarray(qidf),
                                    jnp.asarray(dbT), N, topk=K, block_q=Q,
                                    block_c=bc, interpret=True)
    v2, i2 = k2.bm25_topk(torch.from_numpy(qry.astype(np.int32)),
                          torch.from_numpy(qidf), torch.from_numpy(dbT), N, K)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))


@pytest.mark.parametrize("chunk", [64, 1000, 100_000])
def test_plain_topk_does_not_depend_on_chunking(chunk):
    db, qry = _data(2, 1500, 64, 3, 5)
    qidf = torch.from_numpy(jbm25._map_to_idf(qry, jbm25._compute_idf_tables(db)))
    dbT = torch.from_numpy(np.ascontiguousarray(db.T.astype(np.int32)))
    q = torch.from_numpy(qry.astype(np.int32))
    want = k2.bm25_topk_reference(q, qidf, dbT, 1500, 8, chunk_size=1500)
    got = k2.bm25_topk_reference(q, qidf, dbT, 1500, 8, chunk_size=chunk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


RETRIEVAL = {
    "heavy_ties_f3": dict(N=3000, Q=333, F=3, vocab=6, K=5),
    "f11_pool_not_chunk_multiple": dict(N=1237, Q=150, F=11, vocab=40, K=7),
    "k_exceeds_pool": dict(N=6, Q=40, F=3, vocab=4, K=10),
    "searchsorted_negative_ids": dict(N=900, Q=131, F=4, vocab=30, K=5, lo=-20),
    "robertson": dict(N=800, Q=129, F=3, vocab=8, K=6, generation=1),
    "robertson_k_exceeds_pool": dict(N=5, Q=20, F=3, vocab=3, K=8,
                                     idf_weighting="robertson"),
}


@pytest.mark.parametrize("name", sorted(RETRIEVAL))
def test_retrieval_matches_jax(name):
    cfg = dict(RETRIEVAL[name])
    N, Q, F, vocab, K = (cfg.pop(k) for k in ("N", "Q", "F", "vocab", "K"))
    db, qry = _data(3, N, Q, F, vocab, cfg.pop("lo", 0))
    # query counts that are no multiple of 128; JAX gets its own
    # batching and chunking, the port another: outputs must not care
    want = jbm25.bm25_topk_retrieval(db, qry, topK=K, qry_batch_size=100,
                                     db_chunk_size=256, **cfg)
    got = tbm25.bm25_topk_retrieval(db, qry, topK=K, qry_batch_size=77,
                                    db_chunk_size=300, device="cpu", **cfg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_dense_pack_used_for_nonnegative_ids_only():
    db, _ = _data(4, 100, 2, 3, 9)
    tables = tbm25._compute_idf_tables(db)
    assert tbm25._pack_idf_dense(tables, "cpu") is not None
    assert tbm25._pack_idf_dense(tbm25._compute_idf_tables(db - 5), "cpu") is None


def test_idf_lookups_match_host_map():
    db, qry = _data(5, 2000, 500, 4, 300)
    tables = jbm25._compute_idf_tables(db)
    want = jbm25._map_to_idf(qry, tables)
    q = torch.from_numpy(qry.astype(np.int32))
    dense = tbm25._idf_lookup_dense(q, *tbm25._pack_idf_dense(tables, "cpu"))
    sorted_ = tbm25._idf_lookup(q, *tbm25._pack_idf_tables(tables, "cpu"))
    np.testing.assert_array_equal(dense.numpy(), want)
    np.testing.assert_array_equal(sorted_.numpy(), want)


def test_exact_match_and_cuda_default_raise():
    db, qry = _data(6, 50, 5, 3, 5)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tbm25.bm25_topk_retrieval(db, qry, topK=3, device="cpu",
                                  exact_match_col_indices=[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbm25.bm25_topk_retrieval(db, qry, topK=3)


_INT_MAX = np.iinfo(np.int32).max


def _better(s, i, s2, i2):
    return s > s2 or (s == s2 and i < i2)


def _emulate_kernel(qry, qidf, dbT, valid_len, K, parts, rows):
    """numpy model of csrc/bm25_topk.cu's order of work, not of its
    function: the pool cut into ``parts`` of ``rows`` rows; in each part
    a per-query list fed rows in increasing index (in parts after the
    first, from K (0, INT_MAX) placeholders when the query's IDF are all
    >= 0, so rows of score 0 never enter), groups of 4 rows
    tested once with a strict ``>`` of their max against the K-th best,
    then each row of a passing group inserted after every entry with an
    equal or higher score; the parts' lists merged in pool order with
    the lexicographic (score desc, index asc) compare, each part's list
    ending at its first entry that does not beat the K-th best."""
    B, F = qry.shape
    C = dbT.shape[1]
    lists = []
    for p in range(parts):
        lo, hi = p * rows, min(C, (p + 1) * rows)
        s = np.zeros((B, hi - lo), np.float32)
        for f in range(F):   # fields added in ascending order, float32
            s = np.where(qry[:, f, None] == dbT[f, None, lo:hi],
                         s + qidf[:, f, None], s).astype(np.float32)
        s[:, max(valid_len - lo, 0):] = 0
        # parts after the first start from a bar of 0 for queries whose
        # IDF are all >= 0 (K placeholder entries (0, INT_MAX))
        start = np.where((p > 0) & (qidf >= 0).all(axis=1), 0, -np.inf)
        v = np.repeat(start[:, None], K, axis=1).astype(np.float32)
        ix = np.full((B, K), _INT_MAX, np.int64)
        for g in range(lo, hi, 4):
            grp = s[:, g - lo:min(g + 4, hi) - lo]
            for b in np.nonzero(grp.max(axis=1) > v[:, K - 1])[0]:
                for j, sc in enumerate(grp[b]):
                    if sc > v[b, K - 1]:
                        pos = np.searchsorted(-v[b], -sc, side="right")
                        v[b, pos + 1:], ix[b, pos + 1:] = v[b, pos:-1].copy(), ix[b, pos:-1].copy()
                        v[b, pos], ix[b, pos] = sc, g + j
        lists.append((v, ix))
    out_v = np.empty((B, K), np.float32)
    out_i = np.empty((B, K), np.int64)
    for b in range(B):
        top = [(-np.inf, _INT_MAX)] * K
        for v, ix in lists:
            for k in range(K):
                cand = (v[b, k], ix[b, k])
                if not _better(*cand, *top[K - 1]):
                    break
                pos = next(p for p in range(K) if _better(*cand, *top[p]))
                top = top[:pos] + [cand] + top[pos:K - 1]
        out_v[b] = [t[0] for t in top]
        out_i[b] = [t[1] for t in top]
    return out_v, out_i.astype(np.int32)


# name: (N, Q, F, vocab, K)
EMULATION_CASES = {
    "heavy_ties_vocab6": (3000, 200, 3, 6, 5),
    "k_above_pool_rows": (6, 40, 3, 4, 10),
    "pool_not_tile_multiple": (1237, 150, 4, 40, 5),
    "f11": (900, 100, 11, 30, 7),
    "k32": (2000, 64, 3, 12, 32),
}


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_kernel_order_of_work_matches_plain_and_pallas(name):
    """The kernel's algorithm (numpy emulation) against the plain K2 and
    the JAX fused kernel in interpret mode, raw (pre-drop) output,
    exactly; cut at the kernel's tile (512 rows) and at a 64-row tile,
    which gives more parts to merge."""
    N, Q, F, vocab, K = EMULATION_CASES[name]
    db, qry = _data(8, N, Q, F, vocab)
    qidf = jbm25._map_to_idf(qry, jbm25._compute_idf_tables(db))
    bc = 512
    C = max(N, bc) + (-max(N, bc)) % bc
    dbT = np.zeros((F, C), np.int32)
    dbT[:, :N] = db.T
    q32 = qry.astype(np.int32)
    v1, i1 = bm25_topk_fused_pallas(jnp.asarray(q32), jnp.asarray(qidf), jnp.asarray(dbT),
                                    N, topk=K, block_q=Q, block_c=bc, interpret=True)
    v2, i2 = k2.bm25_topk_reference(torch.from_numpy(q32), torch.from_numpy(qidf),
                                    torch.from_numpy(dbT), N, K)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    for tile in (512, 64):
        parts, rows = k2._geometry(Q, C, 16, 128, tile)
        v3, i3 = _emulate_kernel(q32, qidf, dbT, N, K, parts, rows)
        np.testing.assert_array_equal(v3, v2.numpy(), err_msg="tile {}".format(tile))
        np.testing.assert_array_equal(i3, i2.numpy(), err_msg="tile {}".format(tile))


@pytest.mark.parametrize("B", [5000, 4096, 472])
@pytest.mark.parametrize("C", [1_404_801, 1_264_320, 7])
def test_geometry_covers_every_pool_row_once(B, C):
    """The launch geometry, a pure function of (B, C, resident CTA
    slots, queries per CTA, tile): whole-tile parts that cover rows
    0..C-1 once each, none empty, at most 65,535 of them (grid y), for
    the H100's 132 SMs at 2-8 CTAs each and 128-512 queries per CTA."""
    tile = 512
    for per_sm in (2, 4, 8):
        for qpc in (128, 256, 512):
            parts, rows = k2._geometry(B, C, 132 * per_sm, qpc, tile)
            assert 1 <= parts <= 65535 and rows % tile == 0
            bounds = [(p * rows, min(C, (p + 1) * rows)) for p in range(parts)]
            assert bounds[0][0] == 0 and bounds[-1][1] == C
            assert all(lo < hi for lo, hi in bounds)
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
