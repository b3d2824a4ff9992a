"""The port's retrieval caches and resumable precompute
(rat_tpu_torch/data/loader.py): a scan interrupted after its second
slice and resumed equals an uninterrupted one; a partial with a stale
fingerprint is discarded; a second generator on the same ``.npy`` split
runs no retrieval; on ``.h5`` splits each package reads the other's
``retrieval_{K}_*.h5`` cache. Then the similarity utilities against the
JAX package's."""

import json
import os

import h5py
import numpy as np
import pytest

import rat_tpu.data.loader as jax_loader
import rat_tpu_torch.data.loader as loader
from rat_tpu.retrieval.similarity import jaccard_similarity as jax_jaccard
from rat_tpu.retrieval.similarity import map_indices as jax_map_indices
from rat_tpu_torch.data.loader import DataGenerator
from rat_tpu_torch.retrieval import jaccard_similarity, map_indices

RC = {"used_col_indices": [0, 1, 2], "exact_match_col_indices": None,
      "split_type": "2-fold", "label_wise": False, "pre_retrieval": True,
      "qry_batch_size": None, "db_chunk_size": None, "topK": 4}


def _split(n=120, seed=9):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(1, 6, (n, 3)), rng.randint(0, 2, (n, 1))],
                          axis=1).astype(np.float64)


def _write(directory, arr, name="train.npy"):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    if name.endswith(".h5"):
        with h5py.File(path, "w") as hf:
            hf.create_dataset("data", data=arr)
    else:
        np.save(path, arr)
    return path


def _gen(path, rc, pool="self"):
    return DataGenerator(path, batch_size=16, retrieval_configs=dict(rc),
                         retrieval_pool_fname=pool, retrieval_augmented=True,
                         device="cpu")


def _cache(directory, stem="train", topk=4):
    with np.load(os.path.join(directory, "retrieval_{}_{}.npz".format(topk, stem))) as z:
        return {k: z[k] for k in ("indices", "values", "lens")}


def _partials(directory):
    return sorted(p for p in os.listdir(directory) if p.endswith(".partial"))


class _Engine:
    """Counts the engine's calls and query rows; raises on call ``die``."""

    def __init__(self, monkeypatch, module, die=None):
        self.real, self.calls, self.rows, self.die = module.bm25_topk_retrieval, 0, 0, die
        monkeypatch.setattr(module, "bm25_topk_retrieval", self)

    def __call__(self, *a, **k):
        self.calls += 1
        if self.calls == self.die:
            raise RuntimeError("simulated crash")
        self.rows += len(k["qry_np_data"])
        return self.real(*a, **k)


@pytest.mark.parametrize("label_wise", [False, True])
def test_interrupted_scan_resumes_to_the_uninterrupted_cache(tmp_path, monkeypatch,
                                                             label_wise):
    rc = dict(RC, resume_slice_rows=20, label_wise=label_wise)
    arr = _split()
    clean = str(tmp_path / "clean")
    _gen(_write(clean, arr), rc)
    assert not _partials(clean)

    crash = str(tmp_path / "crash")
    path = _write(crash, arr)
    _Engine(monkeypatch, loader, die=3)
    with pytest.raises(RuntimeError, match="simulated"):
        _gen(path, rc)
    partials = _partials(crash)
    assert partials == ["retrieval_4_train.npz.fold0.{}partial".format(
        "pos." if label_wise else "")]
    with open(os.path.join(crash, partials[0], "cursor.json")) as fh:
        cursor = json.load(fh)
    assert cursor["done_rows"] == 40 and cursor["fingerprint"].startswith("60:")

    monkeypatch.undo()
    engine = _Engine(monkeypatch, loader)
    gen = _gen(path, rc)
    # 2 folds x 60 queries (x2 pools label-wise) in 20-row slices; the
    # 2 slices done before the crash are not scanned again
    total = 2 * 60 * (2 if label_wise else 1)
    assert engine.rows == total - 40
    want = _cache(clean)
    for k, v in _cache(crash).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(gen.retr_indices, want["indices"])
    assert not _partials(crash)


def test_resume_honours_the_cursor_under_another_slice_size(tmp_path, monkeypatch):
    arr = _split()
    clean = str(tmp_path / "clean")
    _gen(_write(clean, arr), dict(RC, resume_slice_rows=20))
    crash = str(tmp_path / "crash")
    path = _write(crash, arr)
    _Engine(monkeypatch, loader, die=3)
    with pytest.raises(RuntimeError):
        _gen(path, dict(RC, resume_slice_rows=20))
    monkeypatch.undo()
    engine = _Engine(monkeypatch, loader)
    _gen(path, dict(RC, resume_slice_rows=7))
    assert engine.rows == 120 - 40
    want = _cache(clean)
    for k, v in _cache(crash).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_partial_with_a_stale_fingerprint_is_discarded(tmp_path, monkeypatch):
    rc = dict(RC, resume_slice_rows=20)
    crash = str(tmp_path / "crash")
    _Engine(monkeypatch, loader, die=3)
    with pytest.raises(RuntimeError):
        _gen(_write(crash, _split(n=120)), rc)
    monkeypatch.undo()
    # the split is rebuilt with another row count: the partial of the old
    # one must not be resumed
    arr = _split(n=100, seed=4)
    path = _write(crash, arr)
    engine = _Engine(monkeypatch, loader)
    _gen(path, rc)
    assert engine.rows == 100
    clean = str(tmp_path / "clean")
    _gen(_write(clean, arr), rc)
    want = _cache(clean)
    for k, v in _cache(crash).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_second_generator_on_an_npy_split_runs_no_retrieval(tmp_path, monkeypatch):
    directory = str(tmp_path)
    train = _write(directory, _split())
    valid = _write(directory, _split(n=30, seed=2), "valid.npy")
    first = (_gen(train, RC), _gen(valid, dict(RC, split_type="sequential"), pool=train))
    assert sorted(f for f in os.listdir(directory) if f.startswith("retrieval_")) == \
        ["retrieval_4_train.npz", "retrieval_4_valid.npz"]
    engine = _Engine(monkeypatch, loader)
    second = (_gen(train, RC), _gen(valid, dict(RC, split_type="sequential"), pool=train))
    assert engine.calls == 0
    for a, b in zip(first, second):
        for name in ("retr_indices", "retr_values", "retr_lens"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_h5_caches_are_shared_with_the_jax_package(tmp_path, monkeypatch):
    """On .h5 splits the port reads the JAX package's retrieval cache
    (running no retrieval), and the JAX package reads the port's."""
    arr = _split()
    jdir, tdir = str(tmp_path / "jax_first"), str(tmp_path / "torch_first")
    jpath, tpath = _write(jdir, arr, "train.h5"), _write(tdir, arr, "train.h5")

    jgen = jax_loader.DataGenerator(jpath, batch_size=16, retrieval_configs=dict(RC),
                                    retrieval_pool_fname="self", retrieval_augmented=True)
    engine = _Engine(monkeypatch, loader, die=1)
    gen = _gen(jpath, RC)
    assert engine.calls == 0
    monkeypatch.undo()

    tgen = _gen(tpath, RC)
    _Engine(monkeypatch, jax_loader, die=1)
    jgen2 = jax_loader.DataGenerator(tpath, batch_size=16, retrieval_configs=dict(RC),
                                     retrieval_pool_fname="self",
                                     retrieval_augmented=True)
    for name in ("retr_indices", "retr_values", "retr_lens"):
        for a, b in ((gen, jgen), (jgen2, tgen), (tgen, jgen)):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


def test_jaccard_similarity_matches_jax():
    rng = np.random.RandomState(0)
    u = rng.randint(0, 6, (9, 4))
    v = rng.randint(0, 6, (7, 5))
    u[:, 0] = np.arange(9) % 3 + 10          # rows of u without repeats
    for pad in (0, 3):
        got = jaccard_similarity(u, v, padding_idx=pad)
        want = np.asarray(jax_jaccard(u, v, padding_idx=pad))
        assert got.dtype == np.float32 or str(got.dtype) == "torch.float32"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_map_indices_matches_jax():
    rng = np.random.RandomState(1)
    keys = rng.permutation(50)[:30]
    queries = rng.randint(0, 60, 40)
    for kw in ({}, {"missing": -7}):
        np.testing.assert_array_equal(map_indices(keys, queries, **kw),
                                      jax_map_indices(keys, queries, **kw))
    sorted_keys = np.sort(keys)
    np.testing.assert_array_equal(map_indices(sorted_keys, queries, is_key_sorted=True),
                                  jax_map_indices(sorted_keys, queries, is_key_sorted=True))
