"""The pool-sharded BM25 scan (rat_tpu_torch/retrieval/sharded.py)
against single-device retrieval, exactly: values, indices and lens.

Each case runs twice: on a 4-rank gloo world (each rank its shard, the
winners all-gathered and merged), and in this process with the 4 shards
scanned in turn. Both must equal the JAX package's single-device
``bm25_topk_retrieval`` on the CPU. A label-wise pool with an empty
sub-pool, which the JAX package's lookup cannot take, is held to the
port's single-device loader, and so are the caches of the X-fold
retrieval routed through the sharded engine in resumable slices."""

import json
import os

import numpy as np
import pytest

from rat_tpu.retrieval import bm25_topk_retrieval as jax_bm25
from rat_tpu_torch.data.loader import DataGenerator, _pool_retrieval
from rat_tpu_torch.retrieval.sharded import sharded_bm25_topk_retrieval
from torch_mesh_world import run_world

SHARDS = 4


def _cases():
    """name -> (pool, queries, engine kwargs)."""
    rng = np.random.RandomState(0)
    common = dict(topK=5, qry_batch_size=16, db_chunk_size=16)
    exm_rng = np.random.RandomState(5)
    scored = exm_rng.randint(0, 4, (400, 5))
    flat = np.concatenate([exm_rng.randint(0, 300, (400, 1)),
                           exm_rng.randint(0, 4, (400, 4))], axis=1)
    near_constant = (rng.rand(500, 4) > 0.9).astype(np.int64)
    return {
        "lucene": (rng.randint(0, 6, (500, 4)), rng.randint(0, 6, (40, 4)), common),
        # value 0 covers ~90% of every column: negative Robertson IDF
        "generation1": (near_constant, (rng.rand(40, 4) > 0.9).astype(np.int64),
                        dict(common, generation=1)),
        "exact_match_scored": (scored, scored[exm_rng.randint(0, 400, 48)],
                               dict(common, exact_match_col_indices=[0, 4])),
        "exact_match_flat": (flat, flat[exm_rng.randint(0, 400, 48)],
                             dict(common, exact_match_col_indices=[0])),
        "tie_heavy": (rng.randint(0, 2, (203, 3)), rng.randint(0, 2, (50, 3)), common),
        # 1001 rows over 4 shards of 256: the last shard holds 233
        "rows_not_divisible": (rng.randint(0, 50, (1001, 3)),
                               rng.randint(0, 50, (64, 3)),
                               dict(common, qry_batch_size=20, db_chunk_size=64)),
        # 6 rows, K = 8: shards of 8 rows hold 6, 0, 0 and 0 real ones
        "k_above_shard_rows": (rng.randint(0, 4, (6, 3)), rng.randint(0, 4, (20, 3)),
                               dict(common, topK=8, db_chunk_size=4)),
    }


def _label_wise_configs():
    return {"used_col_indices": [0, 1, 2], "label_wise": True, "topK": 4,
            "qry_batch_size": 32, "db_chunk_size": 16, "split_type": "pool"}


def _label_wise_arrays():
    rng = np.random.RandomState(9)
    pool = np.concatenate([rng.randint(0, 8, (150, 3)), np.ones((150, 1))], axis=1)
    qry = np.concatenate([rng.randint(0, 8, (40, 3)), rng.randint(0, 2, (40, 1))], axis=1)
    return pool.astype(np.float64), qry.astype(np.float64)


def _xfold_configs():
    return dict(split_type="4-fold", used_col_indices=[0, 1, 2], topK=5,
                qry_batch_size=64, db_chunk_size=100, pre_retrieval=True)


def _xfold_array():
    rng = np.random.RandomState(5)
    return np.concatenate([rng.randint(0, 12, (600, 4)),
                           rng.randint(0, 2, (600, 1))], axis=1).astype(np.float64)


_WORKER = """
import json
import numpy as np
from rat_tpu_torch.data.loader import DataGenerator, _pool_retrieval
from rat_tpu_torch.retrieval.sharded import sharded_bm25_topk_retrieval
arrays, spec = np.load("cases.npz"), json.load(open("cases.json"))
mesh = make_mesh(spec["shards"], 1)
out = {}
for name, kw in spec["cases"].items():
    res = sharded_bm25_topk_retrieval(arrays[name + "/db"], arrays[name + "/q"], mesh, **kw)
    for key, arr in zip(("values", "indices", "lens"), res):
        out[name + "/" + key] = arr
rc = dict(spec["label_wise"], mesh=mesh, sharded_pool_min_rows=1)
got = _pool_retrieval(arrays["label_wise/q"], arrays["label_wise/db"], rc, "cpu")
for key, arr in zip(("indices", "values", "lens"), got):
    out["label_wise/" + key] = arr
# the X-fold retrieval through the sharded engine, in resumable slices of
# 50 queries (3 per fold); rank 0 writes the cache, every rank reads it
rc = dict(spec["xfold"], mesh=mesh, sharded_pool_min_rows=1, resume_slice_rows=50)
gen = DataGenerator("train.npy", batch_size=64, retrieval_configs=rc,
                    retrieval_pool_fname="self", retrieval_augmented=True, device="cpu")
out["xfold/indices"] = gen.retr_indices
out["xfold/values"] = gen.retr_values
out["xfold/lens"] = gen.retr_lens
np.savez("rank%d.npz" % mesh.rank, **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of the 4-rank world, and its directory."""
    work = str(tmp_path_factory.mktemp("sharded_world"))
    arrays, kwargs = {}, {}
    for name, (db, q, kw) in _cases().items():
        arrays[name + "/db"], arrays[name + "/q"], kwargs[name] = db, q, kw
    arrays["label_wise/db"], arrays["label_wise/q"] = _label_wise_arrays()
    np.savez(os.path.join(work, "cases.npz"), **arrays)
    with open(os.path.join(work, "cases.json"), "w") as fh:
        json.dump({"shards": SHARDS, "cases": kwargs, "label_wise": _label_wise_configs(),
                   "xfold": _xfold_configs()}, fh)
    np.save(os.path.join(work, "train.npy"), _xfold_array())
    run_world(_WORKER, SHARDS, work)
    return [dict(np.load(os.path.join(work, "rank{}.npz".format(r))))
            for r in range(SHARDS)], work


def _assert_equal(got, want, name):
    for key, w in zip(("values", "indices", "lens"), want):
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=name + "/" + key)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_world_equals_jax_single_device(world, name):
    db, q, kw = _cases()[name]
    ranks, _ = world
    _assert_equal({k: ranks[0][name + "/" + k] for k in ("values", "indices", "lens")},
                  jax_bm25(db, q, **kw), name)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_shards_in_turn_equal_jax_single_device(name):
    db, q, kw = _cases()[name]
    res = sharded_bm25_topk_retrieval(db, q, n_shards=SHARDS, device="cpu", **kw)
    _assert_equal(dict(zip(("values", "indices", "lens"), res)), jax_bm25(db, q, **kw),
                  name)


def test_every_rank_holds_the_same_results(world):
    ranks, _ = world
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for key in ranks[0]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


def test_label_wise_empty_sub_pool_matches_single_device_loader(world):
    """All pool rows are positive: the negative sub-pool is empty and its
    K slots match nothing (-1, value 0, lens 0), as in the port's
    single-device loader; the positive half equals it too."""
    ranks, _ = world
    pool, qry = _label_wise_arrays()
    want = _pool_retrieval(qry, pool, _label_wise_configs(), "cpu")
    for key, w in zip(("indices", "values", "lens"), want):
        np.testing.assert_array_equal(ranks[0]["label_wise/" + key], w, err_msg=key)
    assert (want[0][:, 4:] == -1).all() and (want[2][:, 1] == 0).all()
    assert (want[2][:, 0] > 0).any()


def test_xfold_caches_through_sharded_slices_equal_single_device(world, tmp_path):
    ranks, work = world
    np.save(str(tmp_path / "train.npy"), _xfold_array())
    gen = DataGenerator(str(tmp_path / "train.npy"), batch_size=64,
                        retrieval_configs=_xfold_configs(), retrieval_pool_fname="self",
                        retrieval_augmented=True, device="cpu")
    written = np.load(os.path.join(work, "retrieval_5_train.npz"))
    for key, attr in (("indices", "retr_indices"), ("values", "retr_values"),
                      ("lens", "retr_lens")):
        np.testing.assert_array_equal(ranks[0]["xfold/" + key], getattr(gen, attr))
        np.testing.assert_array_equal(written[key], getattr(gen, attr))
    assert not [f for f in os.listdir(work) if f.endswith(".partial")]
