"""Training on a 2x1 mesh (two gloo ranks, data parallel) against the
port's single process, on the CPU.

Seeded ML-Tag-shaped splits (2,000 train, 500 valid and 500 test rows
with a learnable signal) with 10-fold self-retrieval, K = 3, batches of
256: a 2-epoch fit, then the valid and test evaluation. AUC and logloss
must be within 1e-3 of the single process's, as the JAX package holds
its mesh (tests/test_parallel.py), and the mesh's checkpoint must load
into a single-device Trainer and give its predictions (within 1e-6:
the same weights, batches cut in two). The dry run runs once more on a
real one-rank mesh, through the spawning launcher."""

import os

import numpy as np
import pytest
import torch

from rat_tpu_torch.data.loader import DataGenerator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.parallel.dryrun import tiny_feature_map, tiny_params
from torch_mesh_world import run_world

RETRIEVAL = {"used_col_indices": [0, 1, 2], "split_type": "10-fold", "label_wise": False,
             "pre_retrieval": True, "qry_batch_size": 500, "db_chunk_size": 1000,
             "topK": 3}


def _rows(rng, n):
    u, i, t = rng.randint(0, 64, n), rng.randint(0, 48, n), rng.randint(0, 32, n)
    logit = 1.2 * (u % 3 == 0) + 0.9 * (i % 2 == 0) + 0.5 * (t % 4 == 0) - 1.3
    y = rng.rand(n) < 1.0 / (1.0 + np.exp(-2.5 * logit))
    return np.stack([u, i, t, y], axis=1).astype(np.float64)


def run_fit(splits, model_root, mesh=None, device=None):
    """Fit for two epochs and evaluate; returns (valid metrics, test
    metrics, test predictions, the trainer)."""
    train, valid, test = splits
    device = device if mesh is None else mesh.device
    common = dict(batch_size=256, retrieval_configs=RETRIEVAL, retrieval_augmented=True,
                  device=device)
    train_gen = DataGenerator(data_array=train, shuffle=True, retrieval_pool_fname="self",
                              **common)
    valid_gen, test_gen = (DataGenerator(data_array=a, pool_array=train,
                                         retrieval_pool_fname="train", **common)
                           for a in (valid, test))
    trainer = Trainer(tiny_feature_map(), tiny_params(batch_size=256,
                                                      model_root=model_root),
                      device=device, mesh=mesh)
    trainer.fit(train_gen, validation_data=valid_gen, epochs=2)
    return (trainer.evaluate(valid_gen), trainer.evaluate(test_gen),
            trainer.predict(test_gen), trainer, test_gen)


_WORKER = """
import numpy as np
import torch
import test_torch_mesh_fit as t
mesh = make_mesh(2, 1)
arrays = np.load("splits.npz")
valid, test, pred, trainer, _ = t.run_fit([arrays[k] for k in ("train", "valid", "test")],
                                          "exps", mesh=mesh)
trainer.save_weights("mesh.model")
if mesh.rank == 0:
    torch.save({"valid": valid, "test": test, "pred": torch.from_numpy(pred),
                "sharded": sorted(trainer._sharded),
                "row_shard": [m.row_shard for m in trainer.model.modules()
                              if hasattr(m, "row_shard")]}, "mesh.pt")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh_fit"))
    rng = np.random.RandomState(17)
    splits = [_rows(rng, n) for n in (2000, 500, 500)]
    np.savez(os.path.join(work, "splits.npz"), train=splits[0], valid=splits[1],
             test=splits[2])
    run_world(_WORKER, 2, work)
    single = run_fit(splits, os.path.join(work, "single_exps"), device="cpu")
    return torch.load(os.path.join(work, "mesh.pt")), single, work


def test_mesh_fit_metrics_match_single_process(runs):
    mesh, (valid, test, _, trainer, _), _ = runs
    assert len(trainer.step_losses) == 2 * 8
    for split, want in (("valid", valid), ("test", test)):
        for metric in ("AUC", "logloss"):
            assert abs(mesh[split][metric] - want[metric]) <= 1e-3, (split, metric)
    assert valid["AUC"] > 0.6


def test_mesh_checkpoint_loads_into_a_single_device_trainer(runs):
    mesh, (_, _, _, trainer, test_gen), work = runs
    trainer.load_weights(os.path.join(work, "mesh.model"))
    np.testing.assert_allclose(trainer.predict(test_gen), mesh["pred"].numpy(), rtol=0,
                               atol=1e-6)


def test_model_axis_of_one_keeps_tables_whole(runs):
    """Pure data parallelism shards no table: the lookup is the local
    one, with no collective over a one-rank model group."""
    mesh = runs[0]
    assert mesh["sharded"] == [] and mesh["row_shard"]
    assert all(r is None for r in mesh["row_shard"])


def test_dryrun_on_a_real_one_rank_mesh(capfd):
    from rat_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(1, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(1): mesh={'data': 1, 'model': 1}" in out and "OK" in out


def test_chip_smoke_mesh_phase_on_cpu(tmp_path):
    """chip_smoke's mesh phase as a function at a tiny size: (a) 4 shards
    in turn equal the unsharded scan; (b) a one-rank gloo group and a 1x1
    mesh (on the card it is NCCL): the sharded 10-fold cache equal to the
    unsharded neighbours, the first step equal to the non-mesh one bit for bit, a
    fit, the round trips; no kernel launches on the CPU."""
    import chip_smoke
    vocab = {"user_id": 60, "item_id": 80, "tag_id": 120}
    pool, test = chip_smoke.mltag_arrays(0, 3000, 300, vocab=vocab)
    res, launches = chip_smoke.mesh_scan("cpu", pool, test)
    # chunks of min(50,000, N) rows: shard 0 holds every real row here
    assert res["equal"] and res["shards"] == 4 and res["shard_rows"] == 3000
    assert launches == {"cross_intra_block": 0, "bm25_topk": 0}
    trainer, gen, _ = chip_smoke.train("cpu", 0, pool, test, 64, str(tmp_path))
    res, launches = chip_smoke.mesh_train("cpu", 0, pool, trainer.valid_gen, 64,
                                          str(tmp_path), gen, trainer, timing_steps=2)
    assert launches == {"cross_intra_block": 0, "bm25_topk": 0}
    assert res["steps"] == len(gen) and res["first_step_loss_abs_err"] == 0
    assert res["first_step_grad_max_abs_err"] == 0 and res["AUC"] > 0.55
    assert len(res["ms_per_step_mesh"]) == len(res["ms_per_step_plain"]) == 2
