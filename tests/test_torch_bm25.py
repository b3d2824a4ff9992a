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
