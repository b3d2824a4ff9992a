"""Training traffic for a configuration with sequence fields, BatchNorm
and embedding dropout (``rat_m2-kkbox``): the window of ``train``
(``Trainer.fit`` on the train split with its X-fold self-retrieval, the
valid split retrieved against it and evaluated at each epoch's end, the
window ending at the first batch boundary after ``--seconds``), reused
by import, with what that configuration needs besides:

- **The set-up check, first.** Before the data, the retrieval and the
  Trainer, the Trainer's loss (``get_loss_fn`` of the configuration's
  ``loss``, the function ``Trainer._loss_fn`` holds) is held on the
  run's device to torch's ``F.binary_cross_entropy``, value and
  gradient, at predictions 0, 1e-7, 0.5, 1 - 6e-8 and 1 and targets 0
  and 1. A value or gradient that is not finite, or departs by more
  than 1e-6 of torch's, ends the run at once with a non-zero exit that
  names it: a loss without a finite gradient at a saturated prediction
  turns the weights NaN the step after a prediction reaches 0 or 1,
  which this configuration's predictions do on some seeds and not on
  others.
- **The feature map** of categorical and sequence fields
  (``dataset.sequences``, ``max_len`` columns each), and retrieval over
  the columns of the configuration's ``used_cols``.
- **The dropout masks.** The model's embedding dropout is wrapped so
  that each training forward also writes the values it kept (its output
  is not 0) into one device buffer, a copy that a captured step graph
  holds as well, so that replays write it too; after each of the
  first ``CHECKED`` optimizer steps of set-up's fit and of the window's,
  a copy of it is kept with the step's state. Nothing the program
  computes changes.
- **What the reference follows**: those steps from the state they
  started from, BatchNorm's running statistics included (the running
  variances held in ``change_gap`` with the moving leaves), each with
  the program's masks, and the last evaluation's predictions of
  ``check_rows`` valid rows from the state that evaluation began with,
  its running statistics among it.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from rat_tpu_torch.data.loader import DataGenerator
from rat_tpu_torch.engine.trainer import get_loss_fn
from rat_tpu_torch.features import FeatureMap

from .. import data, data_seq, program, weights
from ..reference import bm25 as ref_bm25
from ..reference import judge, rat_kkbox
from . import common, train

CHECKED = train.CHECKED
#: the loss check's predictions: 0, small, even, the largest float32
#: below 1, and 1
CHECK_P = (0.0, 1e-7, 0.5, 1.0 - 6e-8, 1.0)
#: the loss check's largest departure from torch's, relative
CHECK_RTOL = 1e-6


def check_loss(loss_fn, device):
    """Hold ``loss_fn`` (elementwise, as the Trainer calls it) to
    ``F.binary_cross_entropy`` at CHECK_P x {0, 1} on ``device``; raises
    SystemExit naming the first departure."""
    for y in (0.0, 1.0):
        values = []
        for fn in (loss_fn, lambda p, t: F.binary_cross_entropy(p, t, reduction="none")):
            p = torch.tensor(CHECK_P, dtype=torch.float32, device=device, requires_grad=True)
            value = fn(p, torch.full_like(p, y))
            grad, = torch.autograd.grad(value.sum(), p)
            values.append((value.detach().cpu().double().numpy(), grad.cpu().double().numpy()))
        (got_v, got_g), (want_v, want_g) = values
        for what, got, want in (("gradient", got_g, want_g), ("value", got_v, want_v)):
            for p, a, b in zip(CHECK_P, got, want):
                if not math.isfinite(a) or abs(a - b) > CHECK_RTOL * abs(b):
                    raise SystemExit(
                        "set-up check failed: the Trainer's loss gives {} {!r} at prediction "
                        "{!r}, target {:g}, where torch's binary_cross_entropy gives {!r}: "
                        "the loss must be torch's, with a finite gradient at a saturated "
                        "prediction".format(what, float(a), p, y, float(b)))


def feature_map(cfg, vocab):
    """The FeatureMap of the configuration's categorical and sequence
    fields, their columns in field order."""
    seqs = cfg["dataset"]["sequences"]
    fm = FeatureMap(cfg["dataset_id"], ".")
    for name, size in vocab.items():
        spec = {"source": "", "type": "categorical", "vocab_size": size}
        if name in seqs:
            spec.update(type="sequence", max_len=seqs[name]["max_len"],
                        encoder=seqs[name]["encoder"])
        fm.feature_specs[name] = spec
    fm.set_feature_index()
    fm.num_fields = len(vocab)
    fm.num_features = sum(vocab.values())
    return fm


def retrieval_columns(cfg, vocab):
    """The id columns of the retrieval's ``used_cols``."""
    first = {name: col for name, col, _, _ in data_seq.columns(cfg, vocab)}
    return [first[c] for c in cfg["dataset"]["retrieval"]["used_cols"]]


def generator(cfg, fm, vocab, batch_size, device, rows, pool=None, shuffle=False):
    """A DataGenerator of ``rows``, as ``program.generator`` makes one,
    its retrieval over the columns of ``used_cols``."""
    rc = dict(cfg["dataset"]["retrieval"], used_col_indices=retrieval_columns(cfg, vocab),
              exact_match_col_indices=None)
    return DataGenerator(data_array=rows, pool_array=pool, batch_size=batch_size,
                         shuffle=shuffle, feature_map=fm, retrieval_configs=rc,
                         retrieval_pool_fname="self" if pool is None else "train",
                         retrieval_augmented=True, device=device)


def record_masks(model):
    """Wrap ``model.emb_drop`` so that each training forward writes the
    values it kept into one device buffer; returns a function that
    gives that buffer (None before the first training forward)."""
    drop = model.emb_drop
    real = drop.forward
    box = [None]

    def forward(x):
        out = real(x)
        if drop.training:
            if box[0] is None or box[0].shape != out.shape:
                box[0] = torch.empty(out.shape, dtype=torch.bool, device=out.device)
            torch.ne(out, 0, out=box[0])
        return out

    drop.forward = forward
    return lambda: box[0]


def record_steps(trainer, masks, into):
    """Copy, on the device and without waiting, the first moments after
    the optimizer's first step, the state dict (BatchNorm's statistics
    included) after its CHECKED-th, and the dropout mask of each of
    those steps, into ``into``, through the optimizer's own hook, which
    then does nothing; returns the hook's handle. (A hook that took
    itself off while the hooks run would change the hooks that
    ``train``'s window registers after it.)"""
    opt = trainer.optimizer
    names = {p: n for n, p in trainer.model.named_parameters()}
    steps = [0]
    into["masks"] = []

    def hook(o, args, kwargs):
        if steps[0] == CHECKED:
            return
        steps[0] += 1
        into["masks"].append(masks().clone())
        if steps[0] == 1:
            into["m1"] = {names[p]: s["exp_avg"].clone() for p, s in o.state.items()}
        if steps[0] == CHECKED:
            into["w3"] = {n: t.detach().clone()
                          for n, t in trainer.model.state_dict().items()}

    return opt.register_step_post_hook(hook)


def setup(run):
    check_loss(get_loss_fn(run.cfg["loss"]), run.device)
    cfg, traffic = run.cfg, run.traffic
    vocab, _, run.batch = data.sizes(cfg, run.rehearse)
    splits = data_seq.splits(cfg, run.seeds["data"], run.rehearse)
    run.splits = {"train": splits["train"], "valid": splits["valid"]}
    run.vocab = vocab
    run.valid_rows = common.sample(len(run.splits["valid"]), traffic["check_rows"],
                                   run.seeds["sample"])
    run.w0 = weights.make(rat_kkbox.param_spec(cfg, vocab), run.seeds["weights"],
                          run.device, traffic["embedding_std"])
    fm = feature_map(cfg, vocab)
    with run.tracer.span("retrieval"):
        run.train_gen = generator(cfg, fm, vocab, run.batch, run.device,
                                  run.splits["train"], shuffle=True)
        run.valid_gen = generator(cfg, fm, vocab, run.batch, run.device,
                                  run.splits["valid"], pool=run.splits["train"])
    trainer = run.trainer = program.BenchTrainer(
        fm, program.params(cfg, run.batch, run.seeds["program"], run.tmp),
        device=run.device)
    trainer.span = run.tracer.span
    program.load_weights(trainer, run.w0)
    run.masks = record_masks(trainer.model)

    run.setup_steps = {}
    run.recording = record_steps(trainer, run.masks, run.setup_steps)
    seen = [0]
    batches = (traffic["rehearsal"] if run.rehearse else traffic)["setup_batches"]

    def stop_after(t):
        seen[0] += 1
        t._stop_training = seen[0] >= batches

    trainer.on_batch = stop_after
    trainer.fit(run.train_gen, run.valid_gen, epochs=1)
    run.setup_steps["losses"] = list(trainer.step_losses[:CHECKED])
    trainer.evaluate(run.valid_gen)


def window(run, seconds):
    record = {}
    run.recording.remove()
    run.recording = record_steps(run.trainer, run.masks, record)
    train.window(run, seconds)
    run.recording.remove()
    run.window_steps.update(record)


class _Follow(train._Follow):
    """``train``'s follow of CHECKED steps, through this reference, with
    the program's dropout ``masks`` of those steps. The change is held
    over the moving leaves and BatchNorm's running variances. Its
    running means are left out, like the leaves that round-off moves:
    the mean of a BatchNorm's input moves with the bias of the Linear
    before it, whose gradient is round-off alone (the BatchNorm takes
    the mean out), and which Adam moves by about its rate all the same,
    another way in the program and in the reference."""

    def __init__(self, run, w0, adam, batches, masks):
        super().__init__(run, w0, adam, batches)
        self.masks = masks

    def steps(self, neighbours, dtype=torch.float32):
        run, split = self.run, self.run.splits["train"]
        inputs = [common.grid_inputs(rows, neighbours[i * run.batch:(i + 1) * run.batch],
                                     split, split, run.device)
                  for i, rows in enumerate(self.batches)]
        return rat_kkbox.train_steps(self.w0, inputs, self.masks, run.cfg, run.layout,
                                     dtype=dtype, adam=self.adam)

    def gaps(self, got, neighbours):
        want = self.norms(*self.steps(neighbours))
        leaves = judge.moving_leaves(want[1]) + [n for n in self.w0
                                                 if n.endswith("running_var")]
        return {"loss_gap": judge.relative_gap(got[0], want[0]),
                "grad_gap": judge.leaf_gap(got[1], want[1]),
                "change_gap": judge.leaf_gap(got[2], want[2], leaves)}


def _retrieval(run, split, pool=None):
    """The reference's retrieval over ``split`` (X-fold) or against
    ``pool``, over the columns of ``used_cols``."""
    return ref_bm25.Retrieval(split, retrieval_columns(run.cfg, run.vocab),
                              run.cfg["dataset"]["retrieval"], common.vocab_rows(run.vocab),
                              run.device, pool=pool)


def check(run):
    """The numbers compared, each the worst over what the reference
    follows, as ``train.check`` takes them. In a control run the
    reference in the control's precision takes the program's place."""
    gen, vgen = run.train_gen, run.valid_gen
    state, adam = run.window_start
    records = (run.setup_steps, run.window_steps)
    follows = [_Follow(run, run.w0, None, train._first_batches(run, 0),
                       run.setup_steps["masks"][:CHECKED]),
               _Follow(run, state, adam, train._first_batches(run, 1),
                       run.window_steps["masks"][:CHECKED])]
    rows = [np.concatenate(f.batches) for f in follows]
    nbs = [gen.retr_indices[r] for r in rows]
    scores = [gen.retr_values[r] for r in rows]
    v_nb, v_scores = vgen.retr_indices[run.valid_rows], vgen.retr_values[run.valid_rows]
    eval_state, eval_pred = run.trainer.eval_state, run.trainer.eval_pred[run.valid_rows]
    run.masks = None
    common.free(run)
    run.layout = rat_kkbox.Layout(run.cfg, run.vocab, run.device)
    ref = _retrieval(run, run.splits["train"])
    vref = _retrieval(run, run.splits["valid"], pool=run.splits["train"])
    gaps, steps = [], []
    for i, (follow, record) in enumerate(zip(follows, records)):
        if run.control:
            gap, nbs[i] = common.control_neighbours(ref, rows[i])
            got = follow.norms(*follow.steps(nbs[i], dtype=common.CONTROL_DTYPE))
        else:
            gap = judge.neighbour_gap(ref.run(rows[i]), ref.db,
                                      torch.from_numpy(nbs[i]).to(run.device),
                                      torch.from_numpy(scores[i]).to(run.device))
            got = train._program_norms(follow, record)
        gaps.append(gap)
        steps.append(follow.gaps(got, nbs[i]))
    if run.control:
        gap, v_nb = common.control_neighbours(vref, run.valid_rows)
    else:
        gap = judge.neighbour_gap(vref.run(run.valid_rows), vref.db,
                                  torch.from_numpy(v_nb).to(run.device),
                                  torch.from_numpy(v_scores).to(run.device))
    gaps.append(gap)
    ids, labels = common.grid_inputs(run.valid_rows, v_nb, run.splits["valid"],
                                     run.splits["train"], run.device)
    want = rat_kkbox.predict(eval_state, ids, labels, run.cfg, run.layout)
    if run.control:
        eval_pred = rat_kkbox.predict(eval_state, ids, labels, run.cfg, run.layout,
                                      dtype=common.CONTROL_DTYPE).cpu().numpy()
    out = {k: max(s[k] for s in steps) for k in steps[0]}
    out.update(nbr_score_gap=max(gaps),
               pred_gap=judge.prediction_gap(eval_pred, want.cpu().numpy()))
    return out
