"""Block streaming (rat_tpu_torch/data/block_loader.py and the Trainer's
block mode) against the JAX package's (rat_tpu.data.block_loader), on
the CPU.

The same seeded blocks are written as ``.h5`` in one directory per
package (each writes its own caches). Counts, views and per-block
caches must be equal exactly, for X-fold self-retrieval, for pool
retrieval against an external block and for inter-block retrieval
(indices, values, lens and the neighbours' rows). A block-mode fit of a
demo-sized RAT_m2 from the JAX Trainer's initial weights must follow
JAX's step losses within the fit-trajectory tolerance of
tests/test_torch_train.py (atol 2e-4). The trainer holds one block on
the device at a time, a recycled ``id()`` cannot hand one block another
block's pool, ``lazy_valid_upload`` evaluates as the resident split
does, and ``profile_dir`` writes a trace."""

import glob
import os
import weakref

import h5py
import jax
import numpy as np
import pytest

from rat_tpu.data.block_loader import DataBlockGenerator as JaxBlockGenerator
from rat_tpu.data.block_loader import _inter_block_retrieval as jax_inter_block
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.data import DataBlockGenerator, get_data_generator
from rat_tpu_torch.data.block_loader import _BlockView, _inter_block_retrieval
from rat_tpu_torch.data.loader import DataGenerator, tfrecord_generator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.features import FeatureMap

RC = {"used_col_indices": [0, 1, 2], "exact_match_col_indices": None,
      "split_type": "3-fold", "label_wise": False, "pre_retrieval": True,
      "qry_batch_size": 16, "db_chunk_size": None, "topK": 4}


def _blocks(rng, sizes, vocab=6):
    out = []
    for n in sizes:
        X = rng.randint(1, vocab, (n, 3))
        y = (rng.rand(n) < 0.3 + 0.1 * (X[:, 0] % 3)).astype(np.float64)
        out.append(np.concatenate([X, y[:, None]], axis=1).astype(np.float64))
    return out


def _write(directory, arrays, split="train", ext=".h5"):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, arr in enumerate(arrays):
        paths.append(os.path.join(directory, "{}_part_{}{}".format(split, i, ext)))
        if ext == ".h5":
            with h5py.File(paths[-1], "w") as hf:
                hf.create_dataset("data", data=arr)
        else:
            np.save(paths[-1], arr)
    return paths


def _gens(tmp_path, arrays, pool=None, **kw):
    """(JAX generator, port generator) over the same blocks, each in its
    own directory; with ``pool``, the blocks retrieve from it."""
    gens = []
    for pkg, cls, extra in (("jax", JaxBlockGenerator, {}),
                            ("torch", DataBlockGenerator, {"device": "cpu"})):
        paths = _write(str(tmp_path / pkg), arrays)
        pool_fname = "self" if pool is None else \
            _write(str(tmp_path / pkg / "pool"), [pool])[0]
        gens.append(cls(paths, retrieval_pool_fname=pool_fname, **dict(kw, **extra)))
    return gens


def _view_arrays(view):
    return (view.darray, view.pool_darray, view.retr_indices, view.retr_values,
            view.retr_lens, view.neighbor_gather_indices(), view.neighbor_valid_mask())


@pytest.mark.parametrize("mode", ["fold", "pool", "inter_block"])
def test_counts_views_and_caches_match_jax(tmp_path, mode):
    rng = np.random.RandomState(0)
    arrays = _blocks(rng, (40, 40, 33))
    pool = _blocks(rng, (50,))[0] if mode == "pool" else None
    rc = dict(RC, inter_block_retrieval=mode == "inter_block")
    jgen, gen = _gens(tmp_path, arrays, pool, batch_size=16, retrieval_configs=rc,
                      retrieval_augmented=True, shuffle=True)
    for name in ("num_blocks", "num_batches", "num_samples", "num_positives",
                 "num_negatives", "topk"):
        assert getattr(gen, name) == getattr(jgen, name), name
    assert len(gen) == len(jgen) == 3 + 3 + 3
    jviews = list(jgen.iter_block_views(rng=np.random.RandomState(5)))
    views = list(gen.iter_block_views(rng=np.random.RandomState(5)))
    assert len(views) == len(jviews) == 3
    for view, jview in zip(views, jviews):
        for a, b in zip(_view_arrays(view), _view_arrays(jview)):
            np.testing.assert_array_equal(a, b)
        batches = list(view.epoch_index_batches(rng=np.random.RandomState(1)))
        jbatches = list(jview.epoch_index_batches(rng=np.random.RandomState(1)))
        assert [v for _, v in batches] == [v for _, v in jbatches]
        for (i, _), (j, _) in zip(batches, jbatches):
            np.testing.assert_array_equal(i, j)
    # a cache per block, the same arrays in each package's file
    tag = "inter_{}_".format(gen._block_set_digest()) if mode == "inter_block" else ""
    assert gen._block_set_digest() == jgen._block_set_digest()
    keys = ["indices", "values", "lens"] + (["neighbor_rows"] if tag else [])
    for i in range(3):
        name = "retrieval_{}4_train_part_{}.h5".format(tag, i)
        with h5py.File(tmp_path / "jax" / name, "r") as a, \
                h5py.File(tmp_path / "torch" / name, "r") as b:
            assert sorted(a.keys()) == sorted(b.keys()) == sorted(keys)
            for key in keys:
                np.testing.assert_array_equal(a[key][()], b[key][()])
    assert set(gen.retrieval_s) == {"train_part_{}.h5".format(i) for i in range(3)}


@pytest.mark.parametrize("qry_block", [0, 2])
def test_inter_block_retrieval_matches_jax(tmp_path, qry_block):
    """The function itself, the last block as the query block included
    (its dropped neighbours take the second-to-last block's last row)."""
    rng = np.random.RandomState(1)
    arrays = _blocks(rng, (30, 25, 20), vocab=40)
    paths = _write(str(tmp_path), arrays)
    rc = dict(RC, topK=5)
    want = jax_inter_block(paths, qry_block, arrays[qry_block], dict(rc))
    got = _inter_block_retrieval(paths, qry_block, arrays[qry_block], dict(rc), "cpu")
    assert (got[0] < 0).any(), "no dropped neighbour in the case"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_npy_blocks_cache_to_npz_like_h5(tmp_path):
    """The port's own ``.npy`` blocks cache to ``.npz`` with the arrays
    the ``.h5`` blocks give, and a second generator reads them."""
    arrays = _blocks(np.random.RandomState(2), (40, 40))
    rc = dict(RC, inter_block_retrieval=True)
    runs = []
    for ext in (".h5", ".npy"):
        paths = _write(str(tmp_path / ext[1:]), arrays, ext=ext)
        gen = DataBlockGenerator(paths, batch_size=16, retrieval_configs=rc,
                                 retrieval_pool_fname="self", retrieval_augmented=True,
                                 device="cpu")
        runs.append([_view_arrays(v) for v in gen.iter_block_views()])
    for va, vb in zip(*runs):
        for a, b in zip(va, vb):
            np.testing.assert_array_equal(a, b)
    caches = sorted(os.listdir(tmp_path / "npy"))
    assert [c for c in caches if c.startswith("retrieval_inter_")] == [
        "retrieval_inter_{}_4_train_part_{}.npz".format(gen._block_set_digest(), i)
        for i in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("rat_tpu_torch.data.block_loader._inter_block_retrieval",
                   lambda *a, **k: pytest.fail("a cache was not read"))
        again = DataBlockGenerator(paths, batch_size=16, retrieval_configs=rc,
                                   retrieval_pool_fname="self", retrieval_augmented=True,
                                   device="cpu")
        for v, want in zip(again.iter_block_views(), runs[1]):
            np.testing.assert_array_equal(v.pool_darray, want[1])


def test_inter_block_digest_changes_with_the_block_set(tmp_path):
    arrays = _blocks(np.random.RandomState(3), (40, 40, 40))
    paths = _write(str(tmp_path), arrays)
    rc = dict(RC, inter_block_retrieval=True)

    def gen(p):
        return DataBlockGenerator(p, batch_size=16, retrieval_configs=rc,
                                  retrieval_pool_fname="self", retrieval_augmented=True,
                                  device="cpu")

    g2, g3 = gen(paths[:2]), gen(paths)
    assert g2._block_set_digest() != g3._block_set_digest()
    v2, v3 = list(g2.iter_block_views()), list(g3.iter_block_views())
    assert len(glob.glob(str(tmp_path / "retrieval_inter_*_train_part_0.h5"))) == 2
    assert not np.array_equal(v2[0].pool_darray, v3[0].pool_darray)
    # a resized block changes it too
    _write(str(tmp_path), [arrays[0], arrays[1][:30], arrays[2]])
    assert gen(paths)._block_set_digest() != g3._block_set_digest()


@pytest.mark.parametrize("bad,ok", [
    (dict(generation=1), False), (dict(idf_weighting="robertson"), False),
    (dict(label_wise=True), False), (dict(exact_match_col_indices=[0]), False),
    (dict(generation=1, idf_weighting="lucene"), True)],
    ids=["generation1", "robertson", "label_wise", "exact_match", "gen1_lucene"])
def test_inter_block_guards(tmp_path, bad, ok):
    """The JAX package's guards, with its effective-IDF rule: generation 1
    with an explicit lucene weighting is accepted."""
    paths = _write(str(tmp_path), _blocks(np.random.RandomState(4), (24, 24)))
    gen = DataBlockGenerator(paths, batch_size=8,
                             retrieval_configs=dict(RC, inter_block_retrieval=True, **bad),
                             retrieval_pool_fname="self", retrieval_augmented=True,
                             device="cpu")
    if ok:
        assert len(list(gen.iter_block_views())) == 2
    else:
        with pytest.raises(ValueError):
            list(gen.iter_block_views())


def test_get_data_generator_dispatch_and_stub(tmp_path):
    paths = _write(str(tmp_path), _blocks(np.random.RandomState(5), (20, 20)), ext=".npy")
    assert isinstance(get_data_generator(paths, batch_size=8), DataBlockGenerator)
    assert isinstance(get_data_generator(paths[:1], batch_size=8), DataGenerator)
    with pytest.raises(NotImplementedError):
        tfrecord_generator()
    # [N, 1+K, F+1] arrays count the positives of their target rows
    grid = np.zeros((6, 3, 4))
    grid[:4, 0, -1] = 1.0
    grid[:, 1:, -1] = 1.0
    assert DataGenerator(data_array=grid, batch_size=4).num_positives == 4


def _view(seed, pool=None):
    """A block view of seeded rows whose pool is ``pool`` (made if None)."""
    pool = np.empty((30, 4)) if pool is None else pool
    pool[:] = _blocks(np.random.RandomState(seed), (30,))[0]
    view = _BlockView(pool, 8, False)
    view.attach_retrieval(pool, np.zeros((30, 2), np.int64), np.ones((30, 2)),
                          np.full(30, 2))
    return view


def _array_at(address, tries=200_000):
    """A new [30, 4] array at ``address``, once the allocator hands it out
    again (the arrays made on the way are kept, so each try is a new
    slot); None if it never does."""
    kept = []
    for _ in range(tries):
        arr = np.empty((30, 4))
        if id(arr) == address:
            return arr
        kept.append(arr)
    return None


def test_pool_upload_cache_is_not_keyed_by_a_recycled_id(tiny_feature_map, demo_params,
                                                         tmp_path):
    """A dropped block view's pool address is handed to a later array, so
    an ``id()`` key would give that later block the dropped block's pool
    upload. The cache holds the array it is keyed by: while the entry
    lives, the address cannot come back, and the next block's upload is
    its own."""
    first = _view(0)
    address = id(first.pool_darray)
    del first
    second = _array_at(address)
    assert second is not None, "the freed address was never reused"
    del second

    tr = Trainer(_port_fm(tiny_feature_map), dict(demo_params, model_root=str(tmp_path)),
                 device="cpu")
    first = _view(0)
    address, alive = id(first.pool_darray), weakref.ref(first.pool_darray)
    tr.device_split(first)
    del first
    assert alive() is not None and _array_at(address, tries=20_000) is None
    for seed in (1, 2):
        tokens = tr.device_split(_view(seed))["pool_tokens"]
        np.testing.assert_array_equal(
            tokens.numpy(), _blocks(np.random.RandomState(seed), (30,))[0][:, :3])


def _port_fm(jfm):
    fm = FeatureMap(jfm.dataset_id, jfm.data_dir)
    fm.from_dict(jfm.to_dict())
    return fm


def _block_gens(root, cls, inter_block=False, **extra):
    """(train, valid) block generators over seeded blocks written under
    ``root``: three shuffled train blocks retrieving from themselves,
    two valid blocks retrieving from the first train block."""
    rng = np.random.RandomState(7)
    arrays, valid = _blocks(rng, (150, 150, 97)), _blocks(rng, (96, 70))
    paths = _write(root, arrays)
    vpaths = _write(root, valid, split="valid")
    common = dict(batch_size=32, retrieval_augmented=True, **extra,
                  retrieval_configs=dict(RC, topK=2, inter_block_retrieval=inter_block))
    return (cls(paths, shuffle=True, retrieval_pool_fname="self", **common),
            cls(vpaths, retrieval_pool_fname=paths[0], **common))


def _fit_params(demo_params, tmp_path, **over):
    return dict(demo_params, batch_size=32, learning_rate=5e-3, train_scan_batches=0,
                model_root=str(tmp_path / "exps"), **over)


def _recording_evaluate(trainer):
    """Record each evaluation's metrics."""
    evals, evaluate = [], trainer.evaluate

    def recorded(gen, data=None):
        evals.append(evaluate(gen, data))
        return evals[-1]

    trainer.evaluate = recorded
    return evals


def _fit_pair(tmp_path, jfm, demo_params, inter_block=False, **over):
    """(JAX trainer, its step losses, port trainer, generators) from the
    same initial weights, before their fits."""
    params = _fit_params(demo_params, tmp_path, **over)
    out = {"jax": _block_gens(str(tmp_path / "jax"), JaxBlockGenerator, inter_block),
           "torch": _block_gens(str(tmp_path / "torch"), DataBlockGenerator, inter_block,
                                device="cpu")}
    jtr = JaxTrainer(jfm, dict(params))
    jtr.init_state(np.zeros((2, 3, 3), np.int32), np.zeros((2, 3), np.float32))
    jtr._build_steps()
    jlosses, step = [], jtr._jit_train_step

    def recording_step(*args):
        state, loss = step(*args)
        jlosses.append(float(loss))
        return state, loss

    jtr._jit_train_step = recording_step
    tr = Trainer(_port_fm(jfm), dict(params), device="cpu")
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    return jtr, jlosses, tr, out


@pytest.mark.parametrize("inter_block", [False, True], ids=["per_block", "inter_block"])
def test_block_mode_fit_matches_jax(tmp_path, tiny_feature_map, demo_params, inter_block):
    """Three epochs of 14 steps over three shuffled blocks, each epoch
    evaluated on a two-block valid split: the block order and each
    block's rows come from the Trainer's RandomState in the JAX package's
    order, so every step loss follows JAX's within 2e-4, and so does
    every evaluation within 1e-3 (tests/test_torch_train.py)."""
    jtr, jlosses, tr, gens = _fit_pair(tmp_path, tiny_feature_map, demo_params,
                                       inter_block, patience=10)
    jevals, evals = _recording_evaluate(jtr), _recording_evaluate(tr)
    jtr.fit(gens["jax"][0], validation_data=gens["jax"][1], epochs=3)
    tr.fit(gens["torch"][0], validation_data=gens["torch"][1], epochs=3)
    assert len(tr.step_losses) == len(jlosses) == 3 * (5 + 5 + 4)
    np.testing.assert_allclose(tr.step_losses, jlosses, rtol=0, atol=2e-4)
    assert len(evals) == len(jevals) == 3
    for ours, theirs in zip(evals, jevals):
        for k in ("AUC", "logloss"):
            assert abs(ours[k] - theirs[k]) < 1e-3, (evals, jevals)
    # one block on the device at a time: the largest train block, or a
    # valid block with its pool (the first train block)
    rows = lambda n, k: n * (3 * 8 + 4 + k * 8)          # noqa: E731
    pool_rows = lambda n: n * (3 * 8 + 4)                # noqa: E731
    k = 2
    if inter_block:
        train_block = rows(150, k) + pool_rows(150 * k)
    else:
        train_block = rows(150, k) + pool_rows(150)
    valid_block = rows(96, k) + pool_rows(150)
    assert tr.peak_split_bytes == max(train_block, valid_block)


def test_lazy_valid_upload_and_profile(tmp_path, tiny_feature_map, demo_params):
    """The same fit with the valid split resident and uploaded per
    evaluation gives the same evaluations; the profiled fit writes a
    trace."""
    runs = []
    valid_rows = np.concatenate(_blocks(np.random.RandomState(8), (96, 70)))
    for lazy in (False, True):
        train, _ = _block_gens(str(tmp_path / str(lazy)), DataBlockGenerator, device="cpu")
        valid = DataGenerator(data_array=valid_rows, batch_size=32,
                              retrieval_pool_fname="self",
                              retrieval_configs=dict(RC, topK=2),
                              retrieval_augmented=True, device="cpu")
        params = _fit_params(demo_params, tmp_path, lazy_valid_upload=lazy, profile_steps=3,
                             profile_dir=str(tmp_path / "trace") if lazy else None)
        tr = Trainer(_port_fm(tiny_feature_map), params, device="cpu")
        evals = _recording_evaluate(tr)
        tr.fit(train, validation_data=valid, epochs=2)
        assert (tr._valid_data is None) == lazy
        runs.append((evals, list(tr.step_losses)))
    assert runs[0] == runs[1]
    traces = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
