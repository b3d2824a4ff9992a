"""Grouped train and eval dispatch in the port against the JAX package's,
on the CPU: the grouped fit (``train_scan_batches``) against the JAX
package's grouped fit and against the port's own fit in groups of one
batch; the group size's precedence; the groups each epoch dispatches;
the eval window; the graph gate's answers; the tensor learning rate;
chip_smoke's grouped phase and the grouped train bench at a tiny size.
On the CPU the gate closes the CUDA graph, so the grouped loops run
each step eagerly: the same steps at the same batches.

The fits use the shapes of tests/test_trainer.py's grouped-dispatch
test: 300 rows in batches of 128, a group of 2, so each epoch holds a
full group, a group of one batch at an evaluation boundary and the
padded last batch inside a group."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import rat_tpu_torch.engine.trainer as trainer_mod
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu.engine.optim import get_learning_rate as jax_get_lr
from rat_tpu_torch.cli import benchmark as bm
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_learning_rate, set_learning_rate
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: six test workers share the host, and the port's
    per-step and grouped fits are then equal bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeGen:
    """tests/test_trainer.py's generator: a learnable task over 3 fields
    and K random neighbours, batches padded with row 0."""

    def __init__(self, n=512, K=2, F=3, batch_size=128, seed=0, shuffle=True):
        rng = np.random.RandomState(seed)
        X = rng.randint(1, 8, (n, F))
        y = (X[:, 0] >= 4).astype(np.float64)
        self.darray = np.concatenate([X, y[:, None]], axis=1).astype(np.float64)
        self.pool_darray = self.darray
        self.retr_indices = rng.randint(0, n, (n, K)).astype(np.int64)
        self.retr_values = rng.rand(n, K)
        self.retr_lens = np.full(n, K)
        self.retrieval_augmented = True
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_samples = n
        self.num_batches = int(np.ceil(n / batch_size))

    @property
    def topk(self):
        return self.retr_indices.shape[-1]

    def neighbor_gather_indices(self):
        return self.retr_indices.astype(np.int32)

    def epoch_index_batches(self, rng=None):
        order = np.arange(self.num_samples)
        if self.shuffle:
            (rng or np.random).shuffle(order)
        for start in range(0, self.num_samples, self.batch_size):
            batch = order[start:start + self.batch_size]
            valid = len(batch)
            if valid < self.batch_size:
                batch = np.concatenate(
                    [batch, np.zeros(self.batch_size - valid, dtype=batch.dtype)])
            yield batch.astype(np.int32), valid

    def __len__(self):
        return self.num_batches


def _port_map(jfm):
    fm = FeatureMap(jfm.dataset_id, jfm.data_dir)
    fm.from_dict(jfm.to_dict())
    return fm


def _params(demo_params, tmp_path, **over):
    return dict(dict(demo_params, model_root=str(tmp_path), patience=100), **over)


def _record(trainer):
    """Each epoch's loss, and each evaluation's batch count and metrics."""
    losses, evals = [], []
    epoch, evaluate = trainer.train_one_epoch, trainer.evaluate

    def rec_epoch(gen, e):
        out = epoch(gen, e)
        losses.append(float(out[0]))
        return out

    def rec_eval(gen, data=None):
        logs = evaluate(gen, data)
        evals.append((trainer._total_batches, dict(logs)))
        return logs

    trainer.train_one_epoch, trainer.evaluate = rec_epoch, rec_eval
    return losses, evals


def _port_fit(fm, params, jax_init, epochs=3):
    tr = Trainer(fm, params, device="cpu")
    tr.model.load_state_dict(params_from_jax(jax_init))
    losses, evals = _record(tr)
    tr.fit(FakeGen(n=300, seed=3, batch_size=128),
           FakeGen(n=128, seed=4, batch_size=128, shuffle=False), epochs=epochs)
    return tr, losses, evals


def _jax_init(jfm, params):
    jtr = JaxTrainer(jfm, params)
    jtr.init_state(np.zeros((2, 3, 3), np.int32), np.zeros((2, 3), np.float32))
    return jtr


@pytest.mark.parametrize("every_x_epochs", [1, 0.5])
def test_grouped_fit_matches_jax_grouped_fit(tiny_feature_map, demo_params, tmp_path,
                                             every_x_epochs):
    """Both packages' grouped fits under ``train_scan_batches: 2`` from
    the same init and batch order: per-epoch train losses within atol
    2e-4 and the final LR within rtol 1e-6 (test_fit_trajectory_matches_
    jax's tolerances), each evaluation's AUC and logloss within 1e-3 at
    the same batch (its reason there: Adam's sign flips on near-zero
    gradients of the 1e-4-std embedding init)."""
    params = _params(demo_params, tmp_path / "jax", every_x_epochs=every_x_epochs,
                     train_scan_batches=2, learning_rate=1e-2, patience=2)
    jtr = _jax_init(tiny_feature_map, params)
    init = jax.device_get(jtr.state.params)
    jlosses, jevals = _record(jtr)
    jtr.fit(FakeGen(n=300, seed=3, batch_size=128),
            validation_data=FakeGen(n=128, seed=4, batch_size=128, shuffle=False),
            epochs=6)
    tr, losses, evals = _port_fit(_port_map(tiny_feature_map),
                                  dict(params, model_root=str(tmp_path / "torch")), init,
                                  epochs=6)
    assert tr._train_group_size() == 2 == jtr._train_group_size()
    assert len(losses) == len(jlosses) and len(evals) == len(jevals) >= 3
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-4)
    for (at, ours), (jat, theirs) in zip(evals, jevals):
        assert at == jat
        for k in ("AUC", "logloss"):
            assert abs(ours[k] - theirs[k]) < 1e-3, (evals, jevals)
    assert np.isclose(get_learning_rate(tr.optimizer), jax_get_lr(jtr.state.opt_state),
                      rtol=1e-6)
    assert len(tr.step_losses) == int(jtr.state.step)    # the same steps taken


@pytest.mark.parametrize("every_x_epochs", [1, 0.5])
def test_grouped_fit_equals_per_step_fit(tiny_feature_map, demo_params, tmp_path,
                                         every_x_epochs):
    """The port's grouped fit against its fit in groups of one batch
    (``train_scan_batches: 0``) from the same init: every step loss,
    every evaluation (at the same batch), the step count, the LR and
    every final weight equal, bit for bit (one thread: the same eager
    steps in the same order)."""
    init = jax.device_get(_jax_init(tiny_feature_map, _params(demo_params, tmp_path))
                          .state.params)
    runs = []
    for group in (0, 2):
        params = _params(demo_params, tmp_path / str(group), every_x_epochs=every_x_epochs,
                         train_scan_batches=group, learning_rate=1e-2)
        runs.append(_port_fit(_port_map(tiny_feature_map), params, init))
    (step, s_losses, s_evals), (grp, g_losses, g_evals) = runs
    assert step._train_group_size() == 0 and grp._train_group_size() == 2
    assert len(step.step_losses) == len(grp.step_losses) == 9
    assert step.step_losses == grp.step_losses and s_losses == g_losses
    assert [at for at, _ in s_evals] == [at for at, _ in g_evals]
    assert len(s_evals) == (3 if every_x_epochs == 1 else 6)
    assert s_evals == g_evals
    assert get_learning_rate(step.optimizer) == get_learning_rate(grp.optimizer)
    for (name, a), (_, b) in zip(step.model.state_dict().items(),
                                 grp.model.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("env, key, want", [
    (None, None, 64), (None, 8, 8), ("16", 8, 16), ("1", 8, 0), (None, 1, 0),
    (None, 0, 0), ("0", None, 0), ("-3", 64, 0)])
def test_train_group_size_precedence(tiny_feature_map, demo_params, tmp_path, monkeypatch,
                                     env, key, want):
    """RAT_TPU_TRAIN_SCAN_BATCHES over ``train_scan_batches`` over 64, as
    the JAX package reads them; 1 or less turns grouping off."""
    params = _params(demo_params, tmp_path)
    if key is not None:
        params["train_scan_batches"] = key
    if env is None:
        monkeypatch.delenv("RAT_TPU_TRAIN_SCAN_BATCHES", raising=False)
    else:
        monkeypatch.setenv("RAT_TPU_TRAIN_SCAN_BATCHES", env)
    tr = Trainer(_port_map(tiny_feature_map), params, device="cpu")
    jtr = JaxTrainer(tiny_feature_map, params)
    assert tr._train_group_size() == want == jtr._train_group_size()


@pytest.mark.parametrize("profile_epoch, group, every_x_epochs, n_rows, want", [
    (True, 2, 1, 300, [[1, 1, 1], [2, 1]]),
    (False, 2, 1, 300, [[2, 1], [2, 1]]),
    (False, 4, 1, 1100, [[4, 4, 1], [4, 4, 1]]),
    (False, 4, 0.5, 1100, [[4, 1, 4], [4, 1, 4]])])
def test_profiling_epoch_runs_per_step(tiny_feature_map, demo_params, tmp_path, monkeypatch,
                                       profile_epoch, group, every_x_epochs, n_rows, want):
    """Every batch of every epoch passes through Trainer.train_scan, in
    groups of ``train_scan_batches`` cut at each evaluation boundary
    (1100 rows: 9 batches an epoch). With ``profile_dir`` the first
    epoch dispatches groups of one batch, each run by train_step, and
    writes the trace and the spans beside it; the next epoch is
    grouped."""
    trace = tmp_path / "trace"
    params = _params(demo_params, tmp_path, train_scan_batches=group,
                     every_x_epochs=every_x_epochs,
                     profile_dir=str(trace) if profile_epoch else None)
    tr = Trainer(_port_map(tiny_feature_map), params, device="cpu")
    groups, steps, eager = [], [], set()
    scan, step, epoch = tr.train_scan, tr.train_step, tr.train_one_epoch

    def spy_scan(data, idx_group, valid_group, *rest):
        groups[-1].append(len(valid_group))
        eager.update(rest)
        return scan(data, idx_group, valid_group, *rest)

    def spy_step(*a):
        steps[-1] += 1
        return step(*a)

    def spy_epoch(*a):
        groups.append([])
        steps.append(0)
        return epoch(*a)

    monkeypatch.setattr(tr, "train_scan", spy_scan)
    monkeypatch.setattr(tr, "train_step", spy_step)
    monkeypatch.setattr(tr, "train_one_epoch", spy_epoch)
    gen = FakeGen(n=n_rows, seed=3)
    tr.fit(gen, FakeGen(n=128, seed=4, shuffle=False), epochs=2)
    assert groups == want
    assert steps == [len(gen)] * 2 == [sum(g) for g in groups]
    assert eager == {True}      # the gate's answer on the CPU, passed down
    assert len(tr.step_losses) == 2 * len(gen)
    assert sorted(p.name.split("_")[0] for p in trace.glob("*.json")) == (
        ["spans", "trace"] if profile_epoch else [])
    assert tr._graph_gate("train", profiling=profile_epoch) == "the CPU"


def test_eval_collect_bounds_inflight_groups(tiny_feature_map, demo_params, monkeypatch):
    """The port's counterpart of tests/test_trainer.py's test: never more
    than the window of dispatched groups pending before the oldest is
    fetched, fetched in order, every valid row kept."""
    tr = Trainer(_port_map(tiny_feature_map), demo_params, device="cpu")
    tr._EVAL_MAX_INFLIGHT_GROUPS = 2
    live, max_live, fetched = [], [], []

    def dispatch(gen, data=None):
        for g in range(7):
            live.append(g)
            max_live.append(len(live))
            yield (torch.full((1, 4), float(g)), torch.full((1, 4), float(-g)), [3])

    real = trainer_mod._fetched

    def spying(pending):
        pred, true, valids = real(pending)
        g = int(pred[0, 0])
        live.remove(g)
        fetched.append(g)
        return pred, true, valids

    monkeypatch.setattr(tr, "_eval_dispatch", dispatch)
    monkeypatch.setattr(trainer_mod, "_fetched", spying)
    preds, trues = tr._eval_collect(None, data={})
    assert max(max_live) <= tr._EVAL_MAX_INFLIGHT_GROUPS + 1, max_live
    assert fetched == list(range(7))
    np.testing.assert_array_equal(preds, np.repeat(np.arange(7.0), 3))
    np.testing.assert_array_equal(trues, np.repeat(-np.arange(7.0), 3))
    assert (tr._EVAL_SCAN_BATCHES, Trainer._EVAL_MAX_INFLIGHT_GROUPS) == (64, 8)


def test_eval_groups_follow_the_jax_dispatch(tiny_feature_map, demo_params):
    """A 9-batch set in groups of 4: three dispatches of 4, 4 and 1
    batches, one index upload each, the scores those of one batch at a
    time."""
    tr = Trainer(_port_map(tiny_feature_map), demo_params, device="cpu")
    gen = FakeGen(n=9 * 16 - 5, batch_size=16, shuffle=False)
    data = tr.device_split(gen)
    tr._EVAL_SCAN_BATCHES = 4
    tr.model.eval()
    with torch.no_grad():
        groups = list(tr._eval_dispatch(gen, data))
        want = torch.cat([tr._forward(data, torch.from_numpy(i.astype(np.int64)))
                          ["y_pred"][:v, 0] for i, v in gen.epoch_index_batches()])
    assert [len(v) for _, _, v in groups] == [4, 4, 1]
    assert groups[-1][2] == [11]
    got = torch.cat([p[i][:v] for p, _, vs in groups for i, v in enumerate(vs)])
    assert torch.equal(got, want)
    assert np.array_equal(tr.predict(gen, data), want.numpy().astype(np.float64))


@pytest.mark.parametrize("case, want", [
    ("cpu", "the CPU"), ("card", None), ("mesh", None),
    ("dedup", None), ("profiling", "a profiling epoch"),
    ("sgd", None), ("dropout", "dropout"), ("eval_profiling", None),
    ("eval_dropout", None)])
def test_graph_gate_answers(tiny_feature_map, demo_params, monkeypatch, case, want):
    """The gate's answer for each run it closes, checked in that order; the
    card's answer is read with the Trainer's device set to CUDA (no step
    runs). Any optimizer takes the graph (its step runs eagerly after each
    replay), and so do a mesh (its collectives captured) and
    ``dedup_neighbors`` (a fixed-size unique). Dropout closes it only where
    this torch cannot register a generator with a graph; evaluation
    ignores dropout and profiling."""
    over = {"sgd": {"optimizer": "sgd"}, "eval_dropout": {"emb_dropout": 0.1},
            "dedup": {"dedup_neighbors": True}, "dropout": {"emb_dropout": 0.1}}
    tr = Trainer(_port_map(tiny_feature_map), dict(demo_params, **over.get(case, {})),
                 device="cpu")
    if case != "cpu":
        tr.device = torch.device("cuda")
    if case == "mesh":
        tr.mesh = object()
    kind = "eval" if case.startswith("eval") else "train"
    got = tr._graph_gate(kind, profiling=case.endswith("profiling"))
    if case == "dropout":
        can = hasattr(torch.cuda.CUDAGraph, "register_generator_state")
        want = None if can else "dropout without CUDAGraph.register_generator_state"
    assert got == want


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_learning_rate_change_reaches_the_next_group(tiny_feature_map, demo_params, tmp_path,
                                                     optimizer):
    """The rate stays a host float that every step reads (a graphed group
    steps its optimizer eagerly after each replay): a rate set between two
    grouped dispatches governs the second, equal step for step to the
    per-step run with the same change, and the plateau's decay reads it
    back."""
    params = _params(demo_params, tmp_path, optimizer=optimizer, learning_rate=1e-2)
    gen = FakeGen(n=512, seed=3, batch_size=64)
    runs = []
    for group in (0, 4):
        torch.manual_seed(0)
        tr = Trainer(_port_map(tiny_feature_map), params, device="cpu")
        data = tr.device_split(gen)
        batches = [(torch.from_numpy(i.astype(np.int64)), v)
                   for i, v in gen.epoch_index_batches(rng=np.random.RandomState(0))]
        losses = []
        for half in (batches[:4], batches[4:]):
            if group:
                losses.extend(tr.train_scan(data, torch.stack([i for i, _ in half]),
                                            [v for _, v in half]).tolist())
            else:
                losses.extend(float(tr.train_step(data, i, v)) for i, v in half)
            if not losses[4:]:
                set_learning_rate(tr.optimizer, 2.5e-3)
        runs.append((losses, tr))
    (step_losses, step), (group_losses, grp) = runs
    assert step_losses == group_losses
    assert get_learning_rate(grp.optimizer) == 2.5e-3
    assert isinstance(grp.optimizer.param_groups[0]["lr"], float)
    assert grp.lr_decay() == pytest.approx(2.5e-4) == get_learning_rate(grp.optimizer)
    for (name, a), (_, b) in zip(step.model.state_dict().items(),
                                 grp.model.state_dict().items()):
        assert torch.equal(a, b), name


def test_grouped_train_bench_dispatches_groups(monkeypatch):
    """bench_train(group=2): one warm-up group and three windows of two
    groups, each one Trainer.train_scan; a group is at most a window."""
    calls = []
    real = Trainer.train_scan

    def spy(self, data, idx_group, valid_group):
        calls.append(tuple(idx_group.shape))
        return real(self, data, idx_group, valid_group)

    monkeypatch.setattr(Trainer, "train_scan", spy)
    line = bm.bench_train(False, steps=4, warmup=2, group=2, batch_size=16, n_rows=300,
                          device="cpu")
    assert calls == [(2, 16)] * 7 and line["value"] > 0
    calls.clear()
    bm.bench_train(False, steps=3, warmup=1, group=64, batch_size=16, n_rows=300,
                   device="cpu")
    assert calls == [(3, 16)] * 4
    assert chip_smoke.bench_train_steps(16, 64) == (64, 64)
    assert chip_smoke.bench_train_steps(8, 8) == (8, 8)
    assert chip_smoke.bench_train_steps(1, 1) == (1, 1)


def test_chip_smoke_grouped_phase_on_cpu(tmp_path):
    """The phase at a tiny size: on the CPU the gate closes the graph,
    the grouped runs equal the per-step runs bit for bit, and no kernel
    is launched."""
    vocab = {"user_id": 60, "item_id": 80, "tag_id": 120}
    pool, test = chip_smoke.mltag_arrays(0, 1200, 200, vocab=vocab)
    trainer, gen, _ = chip_smoke.train("cpu", 0, pool, test, 32, str(tmp_path))
    kk_vocab = {k: min(v, 40) for k, v in chip_smoke.KKBOX_VOCAB.items()}
    kk_train, kk_valid = chip_smoke.kkbox_arrays(0, 600, 100, vocab=kk_vocab)
    kk_trainer, kk_gen, _ = chip_smoke.kkbox_train("cpu", 0, kk_train, kk_valid, 32,
                                                   str(tmp_path / "kk"), vocab=kk_vocab)
    before = {n: p.detach().clone() for n, p in trainer.model.state_dict().items()}
    launches = (k1.launches, k2.launches)
    res, got = chip_smoke.grouped(trainer, gen, trainer.valid_gen, kk_trainer, kk_gen, 0,
                                  group=4, groups=2, kk_steps=3, window=4)
    assert (k1.launches, k2.launches) == launches
    assert got == {"cross_intra_block": 0, "bm25_topk": 0}
    assert res["steps"] == 8 and res["gate"] == "the CPU" and not res["graph"]
    assert res["bit_equal"] and res["eval"]["pred_bit_equal"]
    assert res["replays"] == 0 and res["eval"]["rows"] == 200
    assert res["kkbox"]["gate"] == "the CPU" and res["kkbox"]["bit_equal"]
    assert res["kkbox"]["dropout"] and res["kkbox"]["batch_norm"]
    assert res["kkbox"]["generator_state_equal"]
    assert set(res["steady_host_ms_per_step"]) == {"per_step", "grouped"}
    assert res["dedup"]["bit_equal"] and res["dedup"]["equal_to_plain"]
    assert res["dedup"]["gate"] == "the CPU" and res["dedup"]["steps"] == 8
    # the trainer is left in the state it was found in
    for n, p in trainer.model.state_dict().items():
        assert torch.equal(p, before[n]), n
