"""The port's full train-state checkpoint (rat_tpu_torch/engine/
checkpoint.py, Trainer.save_train_state / restore_train_state): one
epoch, a save, a restore into a fresh Trainer and one more epoch equal
two uninterrupted epochs bit for bit on the CPU — weights and BatchNorm
buffers, Adam's state and learning rate, the monitor's counters, the
shuffle and dropout RNGs. Then the parameter count against the JAX
Trainer's."""

import numpy as np
import pytest
import torch

from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu_torch.data.loader import DataGenerator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.features import FeatureMap

K = 3


def _feature_map(tiny_feature_map):
    fm = FeatureMap(tiny_feature_map.dataset_id, tiny_feature_map.data_dir)
    fm.from_dict(tiny_feature_map.to_dict())
    return fm


def _gens(fm, n_train=400, n_valid=128):
    rng = np.random.RandomState(5)

    def rows(n):
        u, i, t = rng.randint(0, 20, n), rng.randint(0, 15, n), rng.randint(0, 10, n)
        y = rng.rand(n) < 1 / (1 + np.exp(-(1.5 * (u % 3 == 0) + (i % 2 == 0) - 1.2)))
        return np.stack([u, i, t, y], axis=1).astype(np.float64)

    train, valid = rows(n_train), rows(n_valid)
    rc = {"used_cols": ["user_id", "item_id", "tag_id"], "used_col_indices": [0, 1, 2],
          "exact_match_col_indices": None, "split_type": "4-fold", "label_wise": False,
          "topK": K, "qry_batch_size": 100, "db_chunk_size": 128}
    common = dict(batch_size=64, feature_map=fm, retrieval_augmented=True, device="cpu")
    return (DataGenerator(data_array=train, shuffle=True, retrieval_configs=dict(rc),
                          retrieval_pool_fname="self", **common),
            DataGenerator(data_array=valid, pool_array=train, retrieval_configs=dict(rc),
                          retrieval_pool_fname="train", **common))


@pytest.fixture()
def params(demo_params, tmp_path):
    # BatchNorm and dropout: the buffers and the dropout generator are
    # part of the state to restore
    return dict(demo_params, batch_norm=True, emb_dropout=0.1, net_dropout=0.1,
                learning_rate=5e-3, model_root=str(tmp_path / "exps"))


def _snapshot(tr):
    opt = tr.optimizer.state_dict()
    return {"model": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "opt_state": {i: {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in s.items()} for i, s in opt["state"].items()},
            "lr": [g["lr"] for g in opt["param_groups"]],
            "counters": (tr._best_metric, tr._stopping_steps, tr._total_batches),
            "shuffle": tr._shuffle_rng.get_state()[1:],
            "dropout": tr.dropout_generator.get_state().clone()}


def test_save_restore_resume_equals_uninterrupted(tiny_feature_map, params, tmp_path):
    fm = _feature_map(tiny_feature_map)
    train, valid = _gens(fm)

    torch.manual_seed(0)
    straight = Trainer(fm, dict(params, model_root=str(tmp_path / "a")), device="cpu")
    straight.fit(train, valid, epochs=2)
    want = _snapshot(straight)

    torch.manual_seed(0)
    first = Trainer(fm, dict(params, model_root=str(tmp_path / "b")), device="cpu")
    first.fit(train, valid, epochs=1)
    first_losses = list(first.step_losses)
    first.save_train_state(str(tmp_path / "state"))

    torch.manual_seed(123)     # a fresh Trainer with other initial weights
    resumed = Trainer(fm, dict(params, model_root=str(tmp_path / "c")), device="cpu")
    extra = resumed.restore_train_state(str(tmp_path / "state"))
    assert extra["total_batches"] == len(train)
    resumed.fit(train, valid, epochs=1)
    got = _snapshot(resumed)

    assert first_losses + resumed.step_losses == straight.step_losses
    for name, v in want["model"].items():
        assert torch.equal(got["model"][name], v), name
    assert got["opt_state"].keys() == want["opt_state"].keys()
    for i, state in want["opt_state"].items():
        for k, v in state.items():
            assert torch.equal(got["opt_state"][i][k], v), (i, k)
    assert got["lr"] == want["lr"] and got["counters"] == want["counters"]
    assert all(np.array_equal(a, b) for a, b in zip(got["shuffle"], want["shuffle"]))
    assert torch.equal(got["dropout"], want["dropout"])


def test_count_parameters_matches_jax(tiny_feature_map, params):
    jtr = JaxTrainer(tiny_feature_map, dict(params, batch_norm=False))
    jtr.init_state(np.zeros((2, 1 + K, 3), np.int32), np.zeros((2, 1 + K), np.float32))
    tr = Trainer(_feature_map(tiny_feature_map), dict(params, batch_norm=False),
                 device="cpu")
    for count_embedding in (True, False):
        assert tr.count_parameters(count_embedding) == \
            jtr.count_parameters(count_embedding)
