"""Training traffic: ``Trainer.fit`` as the CLI drives it, on the train
split with its X-fold self-retrieval and the valid split retrieved
against it (evaluation at each epoch's end, the best checkpoint, the LR
plateau).

Set-up retrieves both splits, builds one Trainer, loads the benchmark's
weights, and runs a short fit (``setup_batches`` batches, one grouped
dispatch) and one evaluation, so that cuBLAS, the kernels and torch's
lazy imports are initialised. The window then calls ``fit`` on that same
Trainer, which captures its step graph again as every user's fit does,
and ends at the first batch boundary after ``--seconds``, through the
Trainer's stop flag; it counts the examples of the steps in the
Trainer's own record.

What the reference follows, once the window has closed:

- the first ``CHECKED`` steps of set-up's fit, from the seed's weights
  (an eager step and two replays of the step graph);
- the first ``CHECKED`` steps of the window's fit, from the weights and
  optimizer state that the window started from (copied before the clock
  starts): the graph that the window captures anew;
- the neighbours of those batches' rows and of ``check_rows`` rows of
  the valid split drawn from the seed;
- the predictions of the run's last evaluation for those valid rows,
  from the model's state as that evaluation began.
"""

import time

import numpy as np
import torch

from .. import data, program, weights
from ..reference import judge, rat
from . import common

#: the steps that the reference follows
CHECKED = 3


def _examples(steps, n_rows, batch):
    """The real rows of the first ``steps`` steps of consecutive epochs:
    whole epochs, then full batches (an epoch's partial batch is its
    last)."""
    full, rest = divmod(steps, -(-n_rows // batch))
    return full * n_rows + rest * batch


def _first_batches(run, fit):
    """The row ids of the first CHECKED batches of the ``fit``-th fit (0:
    set-up's, 1: the window's): the Trainer draws each epoch's order by
    ``np.random.RandomState(seed).shuffle`` of the rows in order, and
    set-up's fit ends within its first epoch."""
    rng = np.random.RandomState(run.seeds["program"])
    for _ in range(fit + 1):
        order = np.arange(len(run.splits["train"]))
        rng.shuffle(order)
    return [order[i * run.batch:(i + 1) * run.batch] for i in range(CHECKED)]


def _record_steps(trainer, into):
    """Copy, on the device and without waiting, the first moments after
    the optimizer's first step and the weights after its CHECKED-th into
    ``into``, through the optimizer's own hook, which then takes itself
    off."""
    opt = trainer.optimizer
    names = {p: n for n, p in trainer.model.named_parameters()}
    steps = [0]

    def hook(o, args, kwargs):
        steps[0] += 1
        if steps[0] == 1:
            into["m1"] = {names[p]: s["exp_avg"].clone() for p, s in o.state.items()}
        if steps[0] == CHECKED:
            into["w3"] = {n: p.detach().clone() for p, n in names.items()}
            handle.remove()

    handle = opt.register_step_post_hook(hook)


def setup(run):
    cfg = run.cfg
    vocab, _, run.batch = data.sizes(cfg, run.rehearse)
    splits = data.splits(cfg, run.seeds["data"], run.rehearse)
    run.splits = {"train": splits["train"], "valid": splits["valid"]}
    run.vocab = vocab
    run.valid_rows = common.sample(len(run.splits["valid"]), run.traffic["check_rows"],
                                   run.seeds["sample"])
    run.w0 = weights.make(rat.param_spec(cfg, vocab), run.seeds["weights"], run.device,
                          run.traffic["embedding_std"])
    fm = program.feature_map(cfg, vocab)
    with run.tracer.span("retrieval"):
        run.train_gen = program.generator(cfg, fm, run.batch, run.device,
                                          run.splits["train"], shuffle=True)
        run.valid_gen = program.generator(cfg, fm, run.batch, run.device,
                                          run.splits["valid"], pool=run.splits["train"])
    trainer = run.trainer = program.BenchTrainer(
        fm, program.params(cfg, run.batch, run.seeds["program"], run.tmp),
        device=run.device)
    trainer.span = run.tracer.span
    program.load_weights(trainer, run.w0)

    run.setup_steps = {}
    _record_steps(trainer, run.setup_steps)
    seen = [0]

    def stop_after(t):
        seen[0] += 1
        t._stop_training = seen[0] >= run.traffic["setup_batches"]

    trainer.on_batch = stop_after
    trainer.fit(run.train_gen, run.valid_gen, epochs=1)
    run.setup_steps["losses"] = list(trainer.step_losses[:CHECKED])
    trainer.evaluate(run.valid_gen)


def _start_state(trainer):
    """The weights (the state dict), the optimizer's moments, steps and
    rate that the window starts from, copied."""
    opt = trainer.optimizer
    names = {p: n for n, p in trainer.model.named_parameters()}
    m = {names[p]: s["exp_avg"].clone() for p, s in opt.state.items()}
    v = {names[p]: s["exp_avg_sq"].clone() for p, s in opt.state.items()}
    taken = {names[p]: int(s["step"]) for p, s in opt.state.items()}
    state = {n: t.detach().clone() for n, t in trainer.model.state_dict().items()}
    return state, (m, v, taken, opt.param_groups[0]["lr"])


def window(run, seconds):
    trainer = run.trainer
    trace = run.traffic_trace
    run.window_start = _start_state(trainer)
    run.window_steps = {}
    _record_steps(trainer, run.window_steps)
    program.sync(run.device)
    deadline = time.perf_counter() + seconds
    seen = [0]

    def on_batch(t):
        seen[0] += 1
        if seen[0] >= trace["start_batch"]:
            run.tracer.start()
        if run.tracer.running and seen[0] >= trace["start_batch"] + trace["batches"]:
            run.tracer.stop()
        t._stop_training = time.perf_counter() >= deadline and run.tracer.done

    trainer.on_batch = on_batch
    before = trainer.replays()
    t0 = time.perf_counter()
    with run.tracer.span("fit"):
        trainer.fit(run.train_gen, run.valid_gen, epochs=1 << 30)
    program.sync(run.device)
    wall = time.perf_counter() - t0
    losses = np.asarray(trainer.step_losses)
    run.window_steps["losses"] = list(losses[:CHECKED])
    steps = len(losses)
    examples = _examples(steps, len(run.splits["train"]), run.batch)
    after = trainer.replays()
    run.e2e["train_examples_per_s"] = examples / wall
    run.counters.update(
        window_s=wall, steps=steps, examples=examples, epoch_s=list(trainer.epoch_seconds),
        train_replays=after.get("train", 0) - before.get("train", 0),
        eval_replays=after.get("eval", 0) - before.get("eval", 0))
    run.attempted = steps
    run.failed = int(np.count_nonzero(~np.isfinite(losses)))


def _norms(tensors):
    return {n: float(torch.linalg.vector_norm(t.to(torch.float32)))
            for n, t in tensors.items()}


class _Follow(object):
    """CHECKED steps of one fit as the reference follows them: from the
    weights ``w0`` (a state dict) and the optimizer state ``adam`` (None:
    Adam afresh) over the rows of ``batches``."""

    def __init__(self, run, w0, adam, batches):
        self.run, self.w0, self.adam, self.batches = run, w0, adam, batches

    def steps(self, neighbours, dtype=torch.float32):
        """The reference's (losses, first gradient, last weights) in
        ``dtype`` with the given neighbours [CHECKED * batch, K]."""
        run, split = self.run, self.run.splits["train"]
        inputs = [common.grid_inputs(rows, neighbours[i * run.batch:(i + 1) * run.batch],
                                     split, split, run.device)
                  for i, rows in enumerate(self.batches)]
        offsets = rat.field_offsets(run.vocab, run.device)
        return rat.train_steps(self.w0, inputs, run.cfg, offsets, dtype=dtype, adam=self.adam)

    def norms(self, losses, first, last):
        """(losses, the first gradient's and the change's norms by leaf)."""
        grad = {n: 0.0 for n in self.w0}
        grad.update(_norms(first))
        change = _norms({n: last[n].to(torch.float32) - self.w0[n] for n in self.w0})
        return losses, grad, change

    def gaps(self, got, neighbours):
        """The gaps of ``got`` (losses, gradient norms, change norms)
        against the float32 reference's steps over the same neighbours:
        the worst step's loss, the worst leaf's gradient and change."""
        want = self.norms(*self.steps(neighbours))
        return {"loss_gap": judge.relative_gap(got[0], want[0]),
                "grad_gap": judge.leaf_gap(got[1], want[1]),
                "change_gap": judge.leaf_gap(got[2], want[2],
                                             judge.moving_leaves(want[1]))}


def _program_norms(follow, record):
    """The program's (losses, first gradient, change) norms by leaf from
    what its optimizer's hook copied: the gradient that Adam got on the
    first step is ``(m1 - beta1 * m0) / (1 - beta1)``, ``m0`` being the
    moments it started from (zero when afresh)."""
    b1 = 0.9
    m0 = {} if follow.adam is None else follow.adam[0]
    first = {n: (m - b1 * m0[n] if n in m0 else m) / (1 - b1)
             for n, m in record["m1"].items()}
    return follow.norms(record["losses"], first, record["w3"])


def check(run):
    """The numbers compared, each the worst over what the reference
    follows. In a control run the reference in the control's precision
    takes the program's place."""
    gen, vgen = run.train_gen, run.valid_gen
    state, adam = run.window_start
    follows = [(_Follow(run, run.w0, None, _first_batches(run, 0)), run.setup_steps),
               (_Follow(run, state, adam, _first_batches(run, 1)), run.window_steps)]
    rows = [np.concatenate(f.batches) for f, _ in follows]
    nbs = [gen.retr_indices[r] for r in rows]
    scores = [gen.retr_values[r] for r in rows]
    v_nb, v_scores = vgen.retr_indices[run.valid_rows], vgen.retr_values[run.valid_rows]
    eval_state, eval_pred = run.trainer.eval_state, run.trainer.eval_pred[run.valid_rows]
    common.free(run)
    ref = common.retrieval(run.cfg, run.splits["train"], run.vocab, run.device)
    vref = common.retrieval(run.cfg, run.splits["valid"], run.vocab, run.device,
                            pool=run.splits["train"])
    gaps, steps = [], []
    for i, (follow, record) in enumerate(follows):
        if run.control:
            gap, nbs[i] = common.control_neighbours(ref, rows[i])
            got = follow.norms(*follow.steps(nbs[i], dtype=common.CONTROL_DTYPE))
        else:
            gap = judge.neighbour_gap(ref.run(rows[i]), ref.db, torch.from_numpy(nbs[i])
                                      .to(run.device), torch.from_numpy(scores[i])
                                      .to(run.device))
            got = _program_norms(follow, record)
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
    offsets = rat.field_offsets(run.vocab, run.device)
    want = rat.predict(eval_state, ids, labels, run.cfg, offsets)
    if run.control:
        eval_pred = rat.predict(eval_state, ids, labels, run.cfg, offsets,
                                dtype=common.CONTROL_DTYPE).cpu().numpy()
    out = {k: max(s[k] for s in steps) for k in steps[0]}
    out.update(nbr_score_gap=max(gaps),
               pred_gap=judge.prediction_gap(eval_pred, want.cpu().numpy()))
    return out
