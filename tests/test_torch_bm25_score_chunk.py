"""Kernel K3's plain version (rat_tpu_torch.ops.bm25_score_chunk)
against the JAX package's ``bm25_score_chunk_reference``, bit for bit.

Scores are sums of IDF values selected by integer matches; the port adds
the fields' terms in ascending field order, which on the CPU gives the
bits of JAX's ``jnp.sum`` for the field counts tested here. The
IDF comes from the pool's own lucene tables, as in retrieval; B and C
are ragged (not multiples of the Pallas kernel's blocks), and small
vocabularies give heavy ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.ops.pallas.bm25_scan import \
    bm25_score_chunk_reference as jax_score_chunk
from rat_tpu_torch.ops import bm25_score_chunk as k3
from rat_tpu_torch.retrieval import bm25


def _inputs(seed, B, C, F, vocab):
    rng = np.random.RandomState(seed)
    db = rng.randint(0, vocab, (C, F)).astype(np.int64)
    qry = np.concatenate([db[rng.randint(0, C, B // 2)],
                          rng.randint(0, vocab + 2, (B - B // 2, F))])
    q = torch.from_numpy(qry.astype(np.int32))
    idf = bm25._idf_lookup_dense(q, *bm25._pack_idf_dense(
        bm25._compute_idf_tables(db), "cpu")).contiguous()
    return q, idf, torch.from_numpy(db.astype(np.int32))


# (B, C, F, vocab): F in {1, 3, 11, 16}, ragged B and C; vocab 3-6 is
# tie-heavy (most rows share their score with many others)
CASES = {"f1_ties": (37, 501, 1, 3), "f3_ties": (129, 1003, 3, 6),
         "f3_wide_vocab": (64, 777, 3, 5000), "f11": (77, 513, 11, 50),
         "f16": (33, 259, 16, 20)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_equals_jax_bit_for_bit(name):
    q, idf, db = _inputs(sorted(CASES).index(name), *CASES[name])
    want = np.asarray(jax_score_chunk(jnp.asarray(q.numpy()), jnp.asarray(idf.numpy()),
                                      jnp.asarray(db.numpy())))
    before = k3.launches
    got = k3.bm25_score_chunk(q, idf, db)
    assert k3.launches == before, "a CPU call must not count as a launch"
    assert got.dtype == torch.float32 and got.shape == (len(q), len(db))
    np.testing.assert_array_equal(got.numpy(), want)
    if CASES[name][3] <= 6:
        assert len(np.unique(want)) < want.size // 10, "not tie-heavy"


def test_scores_are_what_k2_ranks():
    """K3's scores of a chunk, ranked (score desc, index asc), give K2's
    plain top-K of the same chunk."""
    from rat_tpu_torch.ops import bm25_topk as k2
    q, idf, db = _inputs(9, 50, 300, 3, 6)
    scores = k3.bm25_score_chunk(q, idf, db)
    order = torch.sort(-scores, dim=1, stable=True)
    v, i = k2.bm25_topk_reference(q, idf, db.T.contiguous(), len(db), 5)
    torch.testing.assert_close(-order.values[:, :5], v, rtol=0, atol=0)
    torch.testing.assert_close(order.indices[:, :5].to(torch.int32), i, rtol=0, atol=0)
