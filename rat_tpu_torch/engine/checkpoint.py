"""Full-train-state checkpointing (port of rat_tpu.engine.checkpoint).

Two levels, as in the JAX package:

- ``Trainer.save_weights`` / ``load_weights``: the weights-only
  ``.model`` artifact (the state dict, BatchNorm buffers included);
- ``save_train_state`` / ``restore_train_state``: a directory holding
  ``state.pt`` (``torch.save`` of the model's and the optimizer's state
  dicts: weights, buffers, Adam's moments and step, the learning rate)
  and ``extra.json`` (the Trainer's bookkeeping: best metric, stopping
  steps, total batches, the shuffle RNG's and the dropout generator's
  states), so a run resumes exactly where it stopped.
"""

import json
import os

import torch


def save_train_state(path, model_state, optimizer_state, extra=None):
    """``model_state``/``optimizer_state``: state dicts; ``extra``: a
    small JSON-able dict."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save({"model": model_state, "optimizer": optimizer_state},
               os.path.join(path, "state.pt"))
    if extra is not None:
        with open(os.path.join(path, "extra.json"), "w") as fh:
            json.dump(extra, fh)


def restore_train_state(path, map_location=None):
    """(state dict with "model" and "optimizer", extra dict or None)."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, "state.pt"), map_location=map_location,
                       weights_only=True)
    extra = None
    extra_file = os.path.join(path, "extra.json")
    if os.path.exists(extra_file):
        with open(extra_file) as fh:
            extra = json.load(fh)
    return state, extra
