"""Faults planted underneath the timed path, to see ``correct`` come out
false. Each is a context manager that patches the program for the time
of one run; ``python -m benchmarks.tests.faults <fault> <run.py
arguments>`` runs one cell under one fault (on the card, to read the
numbers a fault gives at the cell's own size).

- ``unchanged_state``: the optimizer's step leaves the weights and its
  state as they were;
- ``half_batch``: half of each batch left out, the mean taken over the
  rest (training: the loss; retrieval: the second half of a batch
  answered with the first half's answers);
- ``altered_answer``: every answer altered where it is produced (an
  evaluation's prediction scaled by 0.99; the first neighbour of each
  query moved to the next row).
"""

import contextlib
import sys

import numpy as np

#: the faults each kind of traffic can have
FAULTS = {"train": ("unchanged_state", "half_batch", "altered_answer"),
          "retrieve": ("half_batch", "altered_answer")}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged_state():
    import torch

    def step(self, closure=None):
        return None

    return _patched(torch.optim.Adam, "step", step)


def _half_batch_loss():
    import torch
    from rat_tpu_torch.engine import trainer

    real = trainer.get_loss_fn

    def get_loss_fn(loss):
        fn = real(loss)

        def half(pred, target):
            rows = torch.arange(pred.shape[0], device=pred.device)
            return fn(pred, target) * (rows < pred.shape[0] // 2).to(pred.dtype) * 2.0
        return half

    return _patched(trainer, "get_loss_fn", get_loss_fn)


def _scaled_predictions():
    from rat_tpu_torch.engine.trainer import Trainer

    real = Trainer._eval_collect

    def collect(self, data_gen, data=None):
        pred, true = real(self, data_gen, data)
        return pred * np.float32(0.99), true

    return _patched(Trainer, "_eval_collect", collect)


def _half_of_each_batch(rows, batch):
    pos = np.arange(len(rows))
    second = pos % batch >= batch // 2
    out = rows.copy()
    out[second] = rows[pos[second] - batch // 2]
    return out


def _retrieval(alter):
    from rat_tpu_torch.data import loader

    real = loader.bm25_topk_retrieval

    def retrieval(db_np_data, qry_np_data, **kwargs):
        res = real(db_np_data=db_np_data, qry_np_data=qry_np_data, **kwargs)
        batch = min(kwargs.get("qry_batch_size") or len(res.indices), len(res.indices))
        return res._replace(indices=alter(res.indices.copy(), len(db_np_data), batch))

    return _patched(loader, "bm25_topk_retrieval", retrieval)


def _moved_first(indices, n_pool, batch):
    indices[:, 0] = (indices[:, 0] + 1) % n_pool
    return indices


def plant(fault, traffic):
    """The context manager that plants ``fault`` for ``traffic``'s runner."""
    if fault not in FAULTS[traffic]:
        raise ValueError("{} traffic has no fault {!r}".format(traffic, fault))
    if fault == "unchanged_state":
        return _unchanged_state()
    if traffic == "train":
        return _half_batch_loss() if fault == "half_batch" else _scaled_predictions()
    if fault == "half_batch":
        return _retrieval(lambda indices, n_pool, batch: _half_of_each_batch(indices, batch))
    return _retrieval(_moved_first)


def main(argv):
    import os
    import time
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from benchmarks import harness
    fault, args = argv[0], argv[1:]
    cell = harness.parse(args).workload
    traffic = harness.resolve(cell)[3]["runner"]
    with plant(fault, traffic):
        return harness.main(args, t_start)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
