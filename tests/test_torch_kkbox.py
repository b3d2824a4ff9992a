"""RAT_m2 at KKBox's shape on the CPU:

- the Trainer's loss is torch's ``F.binary_cross_entropy``, value and
  gradient, at saturated predictions too, and a train step at a
  prediction of exactly 1.0 leaves the weights finite (the JAX
  package's loss, clamped logs alone, gives a NaN gradient there);
- the counters of the path each train step took (``model.path.fused``,
  ``model.path.module``), eager and replayed;
- the port held to the benchmark's plain reference with sequence
  pooling, BatchNorm and embedding dropout
  (``benchmarks/reference/rat_kkbox.py``, which the ``kkbox-train``
  cell's check runs on the card), the program's dropout masks handed
  in: 13 fields of which 2 sequences, d = 40, 8 heads x 10, depth 2.
  Each tolerance is written with its reason and the readings it sits
  between; the same reference computed in bfloat16 must fail it.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmarks import data, data_seq, program, weights
from benchmarks.reference import judge, rat_kkbox
from benchmarks.runners import common, train_masked
from rat_tpu_torch import tracing
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine import step_graph as step_graph_module
from rat_tpu_torch.engine.step_graph import StepGraph
from rat_tpu_torch.engine.trainer import _bce, get_loss_fn
from rat_tpu_torch.features import FeatureMap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SATURATED_P = (0.0, 1.0, 1e-7, 1.0 - 6e-8, 0.5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host. For the whole module, so
    that its module fixtures run on one thread too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)


def _bce_and_grad(fn, y):
    p = torch.tensor(SATURATED_P, dtype=torch.float32, requires_grad=True)
    value = fn(p, torch.full_like(p, y))
    grad, = torch.autograd.grad(value.sum(), p)
    return value.detach(), grad


@pytest.mark.parametrize("y", [0.0, 1.0])
def test_trainer_loss_is_torch_bce_at_saturated_predictions(y):
    value, grad = _bce_and_grad(_bce, y)
    want_value, want_grad = _bce_and_grad(
        lambda p, t: F.binary_cross_entropy(p, t, reduction="none"), y)
    assert torch.isfinite(value).all() and torch.isfinite(grad).all()
    assert torch.equal(value, want_value) and torch.equal(grad, want_grad)
    # at p = 1: 0 for target 1, 1e12 (the bound 1e-12 of p (1 - p)) for 0
    assert float(grad[1]) == pytest.approx(0.0 if y else 1e12, rel=1e-6)
    assert get_loss_fn("binary_crossentropy") is _bce
    # the benchmark's set-up check passes it, and refuses the clamped
    # logs alone, whose gradient at p = 1 (target 0) or 0 (target 1) is NaN
    train_masked.check_loss(_bce, "cpu")

    def clamp_only(pred, target):
        logp = torch.clamp(torch.log(pred), min=-100.0)
        log1mp = torch.clamp(torch.log(1.0 - pred), min=-100.0)
        return -(target * logp + (1.0 - target) * log1mp)

    assert not torch.isfinite(_bce_and_grad(clamp_only, y)[1]).all()
    with pytest.raises(SystemExit, match="gradient nan"):
        train_masked.check_loss(clamp_only, "cpu")


def _tiny_feature_map():
    fm = FeatureMap("tiny", ".")
    for i, (name, size) in enumerate((("user_id", 20), ("item_id", 15), ("tag_id", 10))):
        fm.feature_specs[name] = {"source": "", "type": "categorical",
                                  "vocab_size": size, "index": i}
    fm.num_fields, fm.num_features, fm.input_length = 3, 45, 3
    return fm


def _tiny_split(n=32, seed=4):
    """A device split of ``n`` rows, each with 2 neighbours, as
    Trainer.device_split lays one out, and the labels half 0, half 1."""
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(np.stack([rng.randint(1, v, n) for v in (20, 15, 10)], 1))
    labels = torch.from_numpy((np.arange(n) % 2).astype(np.float32))
    return {"tokens": tokens, "labels": labels, "pool_tokens": tokens,
            "pool_labels": labels, "nbr": torch.from_numpy(rng.randint(0, n, (n, 2)))}


def test_step_at_saturated_prediction_leaves_weights_finite(demo_params, tmp_path):
    trainer = Trainer(_tiny_feature_map(), dict(demo_params, model_root=str(tmp_path)),
                      device="cpu")
    with torch.no_grad():
        trainer.model.fc.bias.fill_(100.0)       # every prediction is exactly 1.0
    split, idx = _tiny_split(), torch.arange(32)
    trainer.model.eval()
    with torch.no_grad():
        assert bool((trainer._forward(split, idx)["y_pred"] == 1.0).all())
    for _ in range(2):
        loss = trainer.train_step(split, idx, 32)
        # half the rows have target 0 at p = 1: a term of 100 each
        assert float(loss) == pytest.approx(50.0, rel=1e-3)
        for name, p in trainer.model.named_parameters():
            assert torch.isfinite(p).all(), name
            assert p.grad is None or torch.isfinite(p.grad).all(), name


def _path_counts():
    c = tracing.counters()
    return c.get("model.path.module", 0), c.get("model.path.fused", 0)


@pytest.mark.parametrize("batch_norm, path", [(True, "module"), (False, "fused")])
def test_path_counters_count_each_step_eager_and_replayed(demo_params, tmp_path,
                                                           monkeypatch, batch_norm, path):
    params = dict(demo_params, model_root=str(tmp_path), batch_norm=batch_norm,
                  use_pallas=True)
    trainer = Trainer(_tiny_feature_map(), params, device="cpu")
    assert trainer.step_path() == "model.path." + path
    split, idx = _tiny_split(), torch.arange(16)
    before = _path_counts()
    tracing.enable()
    try:
        for _ in range(3):
            trainer.train_step(split, idx, 16)
        after_eager = _path_counts()
        # a replay on the CPU, which captures no graph: the captured step
        # run eagerly in the graph's place, past its warm-up and capture
        graph = StepGraph(trainer, "train", split, 16, None)

        class Replay(object):
            def replay(self):
                graph.outputs = graph._step(captured=True)
                graph.grads = [(p, p.grad) for p in trainer.model.parameters()
                               if p.grad is not None]

        graph.graph, graph.warm = Replay(), True
        monkeypatch.setattr(step_graph_module.torch.cuda, "current_stream",
                            lambda device=None: None)
        graph.run(torch.stack([idx] * 4), torch.full((4,), 16.0))
    finally:
        tracing.disable()
    after = _path_counts()
    at = 0 if path == "module" else 1
    assert after_eager[at] - before[at] == 3 and after_eager[1 - at] == before[1 - at]
    assert after[at] - after_eager[at] == 4 and after[1 - at] == before[1 - at]
    assert graph.replays == 4


# ---- the port against the plain reference at KKBox's shape -------------

with open(os.path.join(ROOT, "benchmarks", "configs", "rat_m2-kkbox.json")) as _fh:
    CFG = json.load(_fh)
#: the published widths, depth 2, the rehearsal's vocabularies; a clip
#: at 0.5 against a first gradient of norm ~8, so that the step clips
SMALL = dict(CFG, depth=2, max_gradient_norm=0.5)
B, STEPS = 32, 2


@pytest.fixture(scope="module")
def kkbox(tmp_path_factory):
    """The port's two train steps, and its predictions before them in
    training and after them in evaluation, from the seed's weights with
    BatchNorm statistics drawn at random, with the masks it drew."""
    vocab = data.sizes(SMALL, True)[0]
    rows = data_seq.splits(SMALL, 11, rehearse=True)["train"][:256]
    nbr = np.random.RandomState(3).randint(0, len(rows), (len(rows), 5))
    spec = rat_kkbox.param_spec(SMALL, vocab)
    w0 = weights.make(spec, 5, "cpu", 0.05)
    gen = torch.Generator().manual_seed(9)
    for name, shape, _ in spec:
        if name.endswith("running_mean"):
            w0[name] = torch.randn(shape, generator=gen) * 0.1
        elif name.endswith("running_var"):
            w0[name] = torch.rand(shape, generator=gen) + 0.5
    trainer = Trainer(train_masked.feature_map(SMALL, vocab),
                      program.params(SMALL, B, 7, str(tmp_path_factory.mktemp("exps"))),
                      device="cpu")
    program.load_weights(trainer, w0)
    assert trainer.step_path() == "model.path.module"
    masks = train_masked.record_masks(trainer.model)
    split = {"tokens": torch.from_numpy(rows[:, :-1].astype(np.int64)),
             "labels": torch.from_numpy(rows[:, -1].astype(np.float32)),
             "nbr": torch.from_numpy(nbr)}
    split.update(pool_tokens=split["tokens"], pool_labels=split["labels"])
    batches = [np.arange(i * B, (i + 1) * B) for i in range(STEPS)]
    inputs = [common.grid_inputs(b, nbr[b], rows, rows, "cpu") for b in batches]
    out = {"w0": w0, "vocab": vocab, "inputs": inputs, "losses": [], "masks": []}
    # a training forward alone, its mask and its BatchNorm update undone
    model = trainer.model.train()
    state = trainer.dropout_generator.get_state()
    with torch.no_grad():
        out["train_pred"] = model(*inputs[0])["y_pred"][:, 0].clone()
    out["train_mask"] = masks().clone()
    trainer.dropout_generator.set_state(state)
    program.load_weights(trainer, w0)
    for i, b in enumerate(batches):
        out["losses"].append(float(trainer.loss_and_grads(split, torch.from_numpy(b), B)))
        out["masks"].append(masks().clone())
        if i == 0:
            out["grad"] = {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}
        trainer.optimizer.step()
        if i == 0:
            out["m1"] = {n: trainer.optimizer.state[p]["exp_avg"].clone()
                         for n, p in model.named_parameters() if p in trainer.optimizer.state}
    out["after"] = {n: t.detach().clone() for n, t in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        out["eval_pred"] = model(*inputs[0])["y_pred"][:, 0].clone()
    return out


def _norms(tensors):
    return {n: float(torch.linalg.vector_norm(t.to(torch.float32))) for n, t in tensors.items()}


def _reference(kkbox, dtype):
    """The reference's readings in ``dtype``: the training forward's
    predictions, the first loss's gradient by leaf, the two steps
    (losses, the clipped gradient as Adam got it, the state after), the
    evaluation's predictions from the program's state after them."""
    layout = rat_kkbox.Layout(SMALL, kkbox["vocab"], "cpu")
    (ids, labels), w0 = kkbox["inputs"][0], kkbox["w0"]
    w = {n: t.to(dtype).clone() for n, t in w0.items()}
    names = [n for n in w if not rat_kkbox.is_buffer(n)]
    with torch.no_grad():
        pred = torch.sigmoid(rat_kkbox.logits(dict(w), ids, labels, SMALL, layout,
                                              kkbox["train_mask"])).float()
    w = {n: t.to(dtype).clone().requires_grad_(n in names) for n, t in w0.items()}
    value = rat_kkbox.loss(w, ids, labels, SMALL, layout, kkbox["masks"][0])
    grads = torch.autograd.grad(value, [w[n] for n in names], allow_unused=True)
    losses, clipped, last = rat_kkbox.train_steps(w0, kkbox["inputs"], kkbox["masks"],
                                                  SMALL, layout, dtype=dtype)
    evals = rat_kkbox.predict(kkbox["after"], ids, labels, SMALL, layout, dtype=dtype)
    return {"train_pred": pred,
            "grad": {n: g for n, g in zip(names, grads) if g is not None},
            "losses": losses, "clipped": clipped, "last": last, "eval_pred": evals}


def _gaps(kkbox, ref):
    w0 = kkbox["w0"]
    moving = judge.moving_leaves(_norms(ref["grad"])) + [
        n for n in w0 if n.endswith("running_var")]
    return {
        "train_pred": judge.prediction_gap(kkbox["train_pred"].numpy(),
                                           ref["train_pred"].numpy()),
        "loss": judge.relative_gap(kkbox["losses"], ref["losses"]),
        "grad": judge.leaf_gap(_norms(kkbox["grad"]), _norms(ref["grad"])),
        "adam_moment": judge.leaf_gap(_norms(kkbox["m1"]), _norms(
            {n: 0.1 * g for n, g in ref["clipped"].items()})),
        "change": judge.leaf_gap(
            _norms({n: kkbox["after"][n] - w0[n] for n in w0}),
            _norms({n: ref["last"][n].float() - w0[n] for n in w0}), moving),
        "eval_pred": judge.prediction_gap(kkbox["eval_pred"].numpy(),
                                          ref["eval_pred"].numpy()),
    }


#: each gap's tolerance, between the float32 readings (the first figure
#: below) and the bfloat16 reference's (the second), on this box's CPU:
TOLERANCE = {
    # probabilities in training, BatchNorm on the batch of 32: ~2e-7
    # apart; bfloat16's ~1e-2
    "train_pred": 1e-5,
    # the mean BCE plus the regularizer: ~5e-7 relative; bfloat16 ~1e-2
    "loss": 1e-5,
    # by leaf, against the larger of the leaf's and the median leaf's
    # norm (the Linears before BatchNorm have biases whose gradient is
    # round-off alone): ~2e-7; bfloat16 ~7e-2
    "grad": 1e-5,
    # Adam's first moments, 0.1 x the gradient clipped from ~8 to 0.5:
    # the clip's scale and the moment's update, ~1e-7; bfloat16 ~6e-2
    "adam_moment": 1e-5,
    # the change of the moving leaves and of BatchNorm's running
    # variances over two steps: Adam's division magnifies the round-off
    # of small gradients, ~2e-6; bfloat16 ~1.5
    "change": 1e-4,
    # evaluation on the running statistics: ~2e-8; bfloat16 ~5e-3
    "eval_pred": 1e-6,
}


def test_port_follows_the_kkbox_reference(kkbox):
    gaps = _gaps(kkbox, _reference(kkbox, torch.float32))
    assert {k: v for k, v in gaps.items() if not v <= TOLERANCE[k]} == {}
    assert all(np.isfinite(kkbox["losses"]))
    # the masks drop about a tenth of the grid, and differ step to step
    kept = float(kkbox["masks"][0].float().mean())
    assert 0.85 < kept < 0.95 and not torch.equal(kkbox["masks"][0], kkbox["masks"][1])
    # BatchNorm's running statistics moved
    assert not torch.equal(kkbox["after"]["dnn.norms.0.running_var"],
                           kkbox["w0"]["dnn.norms.0.running_var"])


def test_bfloat16_reference_fails_every_tolerance(kkbox):
    gaps = _gaps(kkbox, _reference(kkbox, torch.bfloat16))
    assert {k: v for k, v in gaps.items() if not v > TOLERANCE[k]} == {}
