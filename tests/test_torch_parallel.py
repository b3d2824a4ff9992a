"""The port's mesh layer (rat_tpu_torch/parallel) on the CPU.

Mesh specs against the JAX package's. Then one 4-rank gloo world, a
2x2 (data x model) mesh with the tables row-sharded over the model axis,
runs one train step per case on the tiny shapes of the JAX package's
mesh tests (``__graft_entry__``: B = 16, K = 3, three fields). The
world's loss is held within 1e-5 of the JAX package's single-device
step from the same (converted) weights, as tests/test_parallel.py holds
the JAX mesh, and its loss, gradients (the sharded tables gathered) and
updated weights to the port's single process: loss within 1e-6,
gradients within rtol 1e-5 and an atol of 1e-7 plus 1e-6 of the
tensor's largest gradient (float32 partial sums reduced in another
order), as tests/test_torch_train.py holds the port to JAX. The same
world resumes a run from a full train state and runs the dry run, and
for every case runs what a step graph captures (StepGraph._step, run
eagerly: the train step on the static row buffer and float32 valid
count, the eval forward on the rank's slice), held bit for bit to the
per-step mesh path.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu.parallel import parse_mesh_spec as jax_parse_mesh_spec
from rat_tpu.parallel.distributed import process_local_rows as jax_local_rows
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.models import build_model
from rat_tpu_torch.parallel import (is_row_sharded, mesh_axes, parse_mesh_spec,
                                    process_local_rows, resolve_mesh, shard_range)
from rat_tpu_torch.parallel.dryrun import (TinySplit, one_step, tiny_feature_map,
                                           tiny_params)
from torch_mesh_world import run_world

K = 3
B = 16

#: name -> (config overrides, valid rows of the 16, start from JAX's init)
CASES = {
    "plain": ({}, 16, True),
    # rows 0-8 valid: data rank 0 holds 8 of them, data rank 1 one
    "padded_last": ({}, 9, True),
    "regularizers": ({"embedding_regularizer": "l1_l2(0.001, 0.02)",
                      "net_regularizer": "l1_l2(0.0001, 0.01)"}, 9, True),
    # a clip at 0.01 always acts; sgd's update shows it (Adam's first
    # step is scale-free)
    "clip": ({"optimizer": "sgd", "learning_rate": 0.5, "max_gradient_norm": 0.01},
             9, True),
    "batch_norm": ({"batch_norm": True}, 9, False),
    "dropout": ({"dropout": 0.2, "emb_dropout": 0.1, "net_dropout": 0.3}, 9, True),
    "dedup_neighbors": ({"dedup_neighbors": True}, 16, True),
    "mask": ({"neighbor_padding": "mask"}, 9, True),
}


@pytest.mark.parametrize("spec", ["4x2", 8, "8", {"data": 2, "model": 4}, None, "none",
                                  "", "1x1"])
def test_parse_mesh_spec_matches_jax(spec):
    assert parse_mesh_spec(spec) == jax_parse_mesh_spec(spec)


def test_resolve_mesh_defaults_and_precedence(monkeypatch):
    monkeypatch.delenv("RAT_TPU_MESH", raising=False)
    assert resolve_mesh({}) is None
    assert resolve_mesh({"mesh": "1x1"}) is None      # trivial mesh -> None
    monkeypatch.setenv("RAT_TPU_MESH", "1x1")
    assert resolve_mesh({}) is None
    monkeypatch.setenv("RAT_TPU_MESH", "4x1")
    assert mesh_axes({}) == (4, 1)
    assert mesh_axes({"mesh": "2x2"}) == (2, 2)
    assert mesh_axes({"mesh": "2x2"}, cli_spec="8") == (8, 1)


def test_process_local_rows_matches_jax(monkeypatch):
    batch = np.arange(12)

    class Mesh:
        data, data_index = 3, 1

    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    np.testing.assert_array_equal(process_local_rows(batch, Mesh),
                                  jax_local_rows(12, batch))
    with pytest.raises(ValueError) as ours:
        process_local_rows(np.arange(10), Mesh)
    with pytest.raises(ValueError) as theirs:
        jax_local_rows(10, np.arange(10))
    assert str(ours.value) == str(theirs.value)


def test_row_sharded_parameters_and_ranges():
    """The packed table and the wide tower's are sharded, the label table
    and everything else replicated; the ranges cover every row once."""
    model = build_model(tiny_feature_map(), tiny_params())
    assert sorted(n for n, p in model.named_parameters() if is_row_sharded(n, p)) == [
        "embedding_layer.table", "lr_layer.embedding_layer.table"]
    for rows, parts in ((144, 2), (17, 4), (17, 16), (5, 3)):
        ranges = [shard_range(rows, parts, i) for i in range(parts)]
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


_WORKER = """
import json
import numpy as np
import torch
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.parallel.dryrun import (TinySplit, dryrun_on_mesh, one_step,
                                           tiny_feature_map, tiny_params)
mesh = make_mesh(4, 2)
cases = json.load(open("cases.json"))
jax_init = torch.load("jax_init.pt")
fm, gen = tiny_feature_map(), TinySplit(k=3)
idx = torch.arange(16)
out = {}
for name, (over, valid, from_jax) in cases.items():
    trainer = Trainer(fm, tiny_params(**over), mesh=mesh)
    if from_jax:
        trainer.load_model_state(jax_init)
    if name == "plain":
        # every rank keeps exactly its rows of the converted weights
        for pname, (rows, lo) in trainer._sharded.items():
            local = dict(trainer.model.named_parameters())[pname]
            out["kept_rows/" + pname] = torch.equal(
                local.detach(), jax_init[pname][lo: lo + local.shape[0]])
    loss, grads, state = one_step(trainer, trainer.device_split(gen), idx, valid)
    out[name] = {"loss": loss, "grads": grads, "state": state}

# resume: 4 epochs against 2, a full-state checkpoint, a fresh trainer,
# 2 more (the 256-row split, batches of 64, shuffled by the trainer)
split = TinySplit(n=256, k=3, batch=64, seed=1, shuffle=True)
valid_split = TinySplit(n=128, k=3, batch=64, seed=2)
params = tiny_params(reduce_lr_on_plateau=False, patience=100, model_root="exps")

def fit(epochs, trainer=None):
    trainer = trainer or Trainer(fm, params, mesh=mesh)
    trainer.fit(split, validation_data=valid_split, epochs=epochs)
    return trainer

whole = fit(4)
half = fit(2)
half.save_train_state("full_state")
resumed = Trainer(fm, params, mesh=mesh)
resumed.restore_train_state("full_state")
fit(2, resumed)
out["resume"] = {"whole": whole.model_state(), "resumed": resumed.model_state(),
                 "whole_opt": whole._optimizer_state()["state"],
                 "resumed_opt": resumed._optimizer_state()["state"],
                 "losses": (whole.step_losses[-8:], resumed.step_losses)}
out["dryrun"] = dryrun_on_mesh(mesh)

# what a step graph captures, run eagerly, against the per-step mesh path
from rat_tpu_torch.engine.step_graph import StepGraph
from rat_tpu_torch.parallel import process_local_rows

def grads_of(trainer):
    grads = {}
    for pname, p in trainer.model.named_parameters():
        if p.grad is not None:
            g = p.grad.detach()
            if pname in trainer._sharded:
                g = trainer._gather_rows(g, trainer._sharded[pname][0])
            grads[pname] = g.clone()
    return grads

out["graph_step"] = {}
for name, (over, valid, from_jax) in cases.items():
    arms = {}
    for arm in ("per_step", "graph"):
        trainer = Trainer(fm, tiny_params(**over), mesh=mesh)
        if from_jax:
            trainer.load_model_state(jax_init)
        data = trainer.device_split(gen)
        if arm == "per_step":
            loss = trainer.loss_and_grads(data, idx, valid)
            grads = grads_of(trainer)
            trainer.model.eval()
            with torch.no_grad():
                res = trainer._forward(data, process_local_rows(idx, mesh))
            pred, true = res["y_pred"][:, 0], res["y_true"][:, 0]
        else:
            train = StepGraph(trainer, "train", data, len(idx), None)
            train.idx.copy_(idx)
            train.valid.fill_(valid)
            loss, = train._step(captured=True)
            grads = grads_of(trainer)
            trainer.model.eval()
            evals = StepGraph(trainer, "eval", data, len(idx), None)
            evals.idx.copy_(idx)
            pred, true = evals._step(captured=True)
        arms[arm] = {"loss": loss.clone(), "grads": grads, "pred": pred.clone(),
                     "true": true.clone()}
    out["graph_step"][name] = arms
torch.save(out, "rank%d.pt" % mesh.rank)
"""


def _jax_init_state():
    jtr = JaxTrainer(graft._tiny_feature_map(), graft._model_params())
    jtr.init_state(np.zeros((B, 1 + K, 3), np.int32), np.zeros((B, 1 + K), np.float32))
    return jtr, params_from_jax(jax.device_get(jtr.state.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of the 2x2 world."""
    work = str(tmp_path_factory.mktemp("mesh_world"))
    with open(os.path.join(work, "cases.json"), "w") as fh:
        json.dump(CASES, fh)
    torch.save(_jax_init_state()[1], os.path.join(work, "jax_init.pt"))
    run_world(_WORKER, 4, work, timeout=240)
    return [torch.load(os.path.join(work, "rank{}.pt".format(r))) for r in range(4)]


@pytest.fixture(scope="module")
def single():
    """The port's single process, case by case, from the same weights."""
    jax_init = _jax_init_state()[1]
    out = {}
    for name, (over, valid, from_jax) in CASES.items():
        trainer = Trainer(tiny_feature_map(), tiny_params(**over), device="cpu")
        if from_jax:
            trainer.load_model_state(jax_init)
        out[name] = one_step(trainer, trainer.device_split(TinySplit(k=K)),
                             torch.arange(B), valid)
    return out


def _close(got, want, name, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=1e-7 + 1e-6 * want.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_matches_single_process(world, single, case):
    loss, grads, state = single[case]
    got = world[0][case]
    assert abs(got["loss"] - loss) <= 1e-6, (got["loss"], loss)
    assert sorted(got["grads"]) == sorted(grads)
    for name, g in grads.items():
        if case == "batch_norm" and name.startswith("dnn.linears.") \
                and name.endswith(".bias") and name != "dnn.linears.2.bias":
            # a bias before BatchNorm has a zero gradient in exact
            # arithmetic; in float32 both runs give noise near 0
            assert got["grads"][name].abs().max() < 1e-3 and g.abs().max() < 1e-3
            continue
        _close(got["grads"][name], g, name)
    for r in world[1:]:
        assert r[case]["loss"] == got["loss"]


def test_mesh_loss_matches_jax_single_device(world):
    """The JAX package's single-device step (trainer.py _train_core) on the
    same batch, from the weights the world started from."""
    for case in ("plain", "padded_last"):
        jtr, _ = _jax_init_state()     # the step donates its state
        jtr._build_steps()
        jdata = jtr.device_split(TinySplit(k=K))
        valid = CASES[case][1]
        _, jloss = jtr._jit_train_step(jtr.state, jdata, jnp.arange(B, dtype=jnp.int32),
                                       jnp.float32(valid), jax.random.PRNGKey(1))
        assert abs(world[0][case]["loss"] - float(jloss)) < 1e-5, case


def test_mesh_batch_norm_statistics_are_the_global_batch(world, single):
    state = single["batch_norm"][2]
    stats = [k for k in state if "running_" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(world[0]["batch_norm"]["state"][k].numpy(),
                                   state[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_mesh_clip_uses_the_global_norm(world, single):
    """The clip's active branch: the updated weights (sgd, so the clip's
    scale shows) equal the single process's, sharded tables included."""
    _, grads, state = single["clip"]
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    assert norm > 0.01 * 10
    for name, w in state.items():
        _close(world[0]["clip"]["state"][name], w, name)


def test_mesh_dedup_neighbors_gives_the_same_loss(world):
    assert world[0]["dedup_neighbors"]["loss"] == world[0]["plain"]["loss"]


def test_mesh_takes_converted_jax_weights(world):
    for r in world:
        kept = {k: v for k, v in r.items() if k.startswith("kept_rows/")}
        assert sorted(kept) == ["kept_rows/embedding_layer.table",
                                "kept_rows/lr_layer.embedding_layer.table"]
        assert all(kept.values())


def test_mesh_resume_equals_uninterrupted(world):
    res = world[0]["resume"]
    np.testing.assert_allclose(res["losses"][1], res["losses"][0], rtol=1e-6)
    for name, w in res["whole"].items():
        np.testing.assert_allclose(res["resumed"][name].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    for i, slot in res["whole_opt"].items():
        for key, v in slot.items():
            if torch.is_tensor(v):
                np.testing.assert_allclose(res["resumed_opt"][i][key].numpy(), v.numpy(),
                                           rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_step_matches_per_step_mesh_path(world, case):
    """What a step graph captures (StepGraph._step: loss_and_grads on the
    static row buffer and the float32 valid count; the eval forward on
    this rank's slice of it), run eagerly on the gloo world, equals the
    per-step mesh path bit for bit on every rank: the loss, every
    gradient (the sharded tables gathered) and the eval predictions and
    labels."""
    for r in world:
        per, graph = r["graph_step"][case]["per_step"], r["graph_step"][case]["graph"]
        assert torch.equal(graph["loss"], per["loss"]), (graph["loss"], per["loss"])
        assert sorted(graph["grads"]) == sorted(per["grads"])
        for name, g in per["grads"].items():
            assert torch.equal(graph["grads"][name], g), name
        assert graph["pred"].shape == (B // 2,)
        assert torch.equal(graph["pred"], per["pred"])
        assert torch.equal(graph["true"], per["true"])
    if case == "dedup_neighbors":
        # the deduplicated gather builds the same grid as the plain one
        plain = world[0]["graph_step"]["plain"]["graph"]
        dedup = world[0]["graph_step"][case]["graph"]
        assert torch.equal(dedup["loss"], plain["loss"])
        assert all(torch.equal(dedup["grads"][n], g) for n, g in plain["grads"].items())
        assert torch.equal(dedup["pred"], plain["pred"])


def test_dryrun_on_a_2x2_mesh(world):
    assert all(r["dryrun"].endswith("OK") for r in world)
    assert "mesh={'data': 2, 'model': 2}" in world[0]["dryrun"]
