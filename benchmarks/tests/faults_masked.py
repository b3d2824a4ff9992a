"""Faults planted underneath the ``train_masked`` runner (the
``kkbox-train`` cell), to see a run refuse them:

- ``unchanged_state`` and ``altered_answer``, as ``faults.py`` plants
  them, and ``half_batch``: half of each batch left out of the loss and
  the mean taken over the rest, planted in ``Trainer.loss_and_grads``
  (a loss function that masks rows, as ``faults.py`` plants it, is no
  longer torch's binary cross-entropy, and the set-up check stops the
  run before the step is reached); each must read ``correct`` false;
- ``clamp_only_bce``: the Trainer's loss as it was before it became
  torch's, each log clamped at -100 and nothing else, so that its
  gradient at a prediction of 0 or 1 is NaN; the run's set-up check
  must stop it with a non-zero exit before any data is made.

``python -m benchmarks.tests.faults_masked <fault> <run.py arguments>``
runs one cell under one fault. ``faults.FAULTS`` names no fault for
this runner, whose faults ``faults.plant`` does not plant.
"""

import sys

from benchmarks.tests import faults

RUNNER = "train_masked"
FAULTS = ("unchanged_state", "half_batch", "altered_answer", "clamp_only_bce")


def _clamp_only_bce(pred, target):
    import torch
    logp = torch.clamp(torch.log(pred), min=-100.0)
    log1mp = torch.clamp(torch.log(1.0 - pred), min=-100.0)
    return -(target * logp + (1.0 - target) * log1mp)


def _half_batch_step():
    from rat_tpu_torch.engine.trainer import Trainer

    real = Trainer.loss_and_grads

    def loss_and_grads(self, data, idx, valid):
        # the loss's rows below ``valid`` / 2, its sum over that count
        return real(self, data, idx, valid * 0.5)

    return faults._patched(Trainer, "loss_and_grads", loss_and_grads)


def plant(fault):
    """The context manager that plants ``fault``."""
    if fault not in FAULTS:
        raise ValueError("{} has no fault {!r}".format(RUNNER, fault))
    if fault == "clamp_only_bce":
        from rat_tpu_torch.engine import trainer
        return faults._patched(trainer, "_bce", _clamp_only_bce)
    if fault == "unchanged_state":
        return faults._unchanged_state()
    if fault == "half_batch":
        return _half_batch_step()
    return faults._scaled_predictions()


def main(argv):
    import os
    import time
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from benchmarks import harness
    fault, args = argv[0], argv[1:]
    with plant(fault):
        return harness.main(args, t_start)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
