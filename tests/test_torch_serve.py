"""The slice as a whole: serving RAT_m2 with pool retrieval, the port
against the JAX package, on the CPU.

Seeded split arrays are written to h5 (one directory per package, so
neither reads the other's retrieval cache). JAX runs
``h5_generator(stage="test")`` + ``Trainer(use_pallas=True).evaluate``;
the port runs the same from the same weights (``params_from_jax``).
Retrieval must be equal, predictions within 1e-5, AUC and logloss
within 1e-6. Then chip_smoke's serve phase runs as a function on the
CPU at a tiny size."""

import os

import h5py
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rat_tpu.data.loader import h5_generator as jax_h5_generator
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.data.loader import DataGenerator, h5_generator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1

K = 3


def _write_splits(root, pool, test):
    os.makedirs(root)
    for name, arr in (("train.h5", pool), ("test.h5", test)):
        with h5py.File(os.path.join(root, name), "w") as hf:
            hf.create_dataset("data", data=arr)
    return os.path.join(root, "train.h5"), os.path.join(root, "test.h5")


def _splits(seed):
    rng = np.random.RandomState(seed)
    vocab = (20, 15, 10)

    def rows(n):
        # the pool leaves out each field's last id
        X = np.stack([rng.randint(0, v - 1, n) for v in vocab], axis=1)
        y = (rng.rand(n) < 0.4).astype(np.float64)
        return np.concatenate([X, y[:, None]], axis=1).astype(np.float64)

    test = rows(301)
    # requests matching nothing in the pool: every neighbour slot is -1
    test[:20, :3] = np.asarray(vocab) - 1
    return rows(900), test


def _retrieval_configs():
    return {"used_cols": ["user_id", "item_id", "tag_id"], "exact_match_cols": [],
            "split_type": "10-fold", "label_wise": False, "pre_retrieval": True,
            "qry_batch_size": 100, "db_chunk_size": 256, "topK": K}


def test_serve_path_matches_jax(tmp_path, tiny_feature_map, demo_params):
    pool, test = _splits(0)
    params = dict(demo_params, depth=2, use_pallas=True,
                  model_root=str(tmp_path / "exps"))
    jtrain, jtest = _write_splits(str(tmp_path / "jax"), pool, test)
    jgen = jax_h5_generator(tiny_feature_map, stage="test", train_data=jtrain,
                            test_data=jtest, batch_size=64,
                            retrieval_configs=_retrieval_configs(),
                            retrieval_augmented=True)
    jtr = JaxTrainer(tiny_feature_map, params)
    assert jtr._use_fast_forward()
    jtr.init_state(np.zeros((2, 1 + K, 3), np.int32),
                   np.zeros((2, 1 + K), np.float32))
    jlogs = jtr.evaluate(jgen)
    jpred = jtr.predict(jgen)

    fm = FeatureMap(tiny_feature_map.dataset_id, tiny_feature_map.data_dir)
    fm.from_dict(tiny_feature_map.to_dict())
    ttrain, ttest = _write_splits(str(tmp_path / "torch"), pool, test)
    gen = h5_generator(fm, stage="test", train_data=ttrain, test_data=ttest,
                       batch_size=64, retrieval_configs=_retrieval_configs(),
                       retrieval_augmented=True, device="cpu")
    tr = Trainer(fm, params, device="cpu")
    assert tr._use_fast_forward()
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))

    # retrieval, including the -1 slots and their wrap to the last pool row
    for name in ("retr_indices", "retr_values", "retr_lens"):
        np.testing.assert_array_equal(getattr(gen, name), getattr(jgen, name))
    assert (gen.retr_indices == -1).any()
    np.testing.assert_array_equal(gen.neighbor_gather_indices(),
                                  jgen.neighbor_gather_indices())
    assert os.path.exists(os.path.join(str(tmp_path / "torch"), "retrieval_3_test.h5"))

    launches = (k1.launches, k2.launches)
    logs = tr.evaluate(gen)
    pred = tr.predict(gen)
    assert (k1.launches, k2.launches) == launches, "CPU calls count no launch"
    assert pred.shape == (len(test),)     # the padded last batch is cut
    np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=1e-5)
    for k in ("AUC", "logloss"):
        assert abs(logs[k] - jlogs[k]) <= 1e-6, (k, logs[k], jlogs[k])

    # the module forward (no K1) agrees too, and weights round-trip
    tr.params = dict(params, use_pallas=False)
    np.testing.assert_allclose(tr.predict(gen), pred, rtol=1e-5, atol=1e-6)
    tr.save_weights(tr.checkpoint)
    tr2 = Trainer(fm, dict(params, seed=5), device="cpu")
    tr2.load_weights(tr.checkpoint)
    np.testing.assert_array_equal(tr2.predict(gen), pred)

    # a second generator reading the cache gives the same neighbours
    gen2 = h5_generator(fm, stage="test", train_data=ttrain, test_data=ttest,
                        batch_size=64, retrieval_configs=_retrieval_configs(),
                        retrieval_augmented=True, device="cpu")
    np.testing.assert_array_equal(gen2.retr_indices, gen.retr_indices)


def test_chip_smoke_serve_phase_on_cpu():
    vocab = {"user_id": 60, "item_id": 80, "tag_id": 120}
    pool, test = chip_smoke.mltag_arrays(0, 3000, 300, vocab=vocab)
    res = chip_smoke.serve("cpu", 0, pool, test, batch_size=128)
    assert res["requests"] == 300 and res["batches"] == 3
    assert res["launches"] == {"cross_intra_block": 0, "bm25_topk": 0}
    assert 0.0 <= res["AUC"] <= 1.0 and np.isfinite(res["logloss"])
    assert res["fused_vs_module_max_abs_err"] <= 1e-5


def test_entry_points_need_cuda_or_an_explicit_cpu(tiny_feature_map, demo_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_feature_map, demo_params)
    pool, test = _splits(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataGenerator(data_array=test, pool_array=pool,
                      retrieval_configs=dict(_retrieval_configs(),
                                             used_col_indices=[0, 1, 2]),
                      retrieval_pool_fname="p", retrieval_augmented=True)
    assert chip_smoke.main([]) == 2
