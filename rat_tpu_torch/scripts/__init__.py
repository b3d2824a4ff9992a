"""The JAX package's run scripts (``scripts/*.py``), one module each under
the same file name, run as ``python -m rat_tpu_torch.scripts.<name>``:

- ``tmall_rehearsal``, ``tmall_rehearsal_tail``: the Tmall-scale build,
  retrieval (kernel K2) and fit of configs/RAT_m2/tmall_x1_002, stage by
  stage;
- ``stall_guard``: a supervisor that restarts a child whose progress
  files stop moving;
- ``profile_train_step``: the bench train step's device time by kernel;
- ``degraded_ab``, ``dedup_ab``: short train-throughput A/Bs (model
  overrides, ``dedup_neighbors`` and the sharded step's collectives);
- ``tax_probe``: marginal cost per op class at the bench shape;
- ``gm_encoder_ab``: the encoder on a fixed [t, s, d, b] layout against
  the module encoder;
- ``chip_health``: the health stamp as one JSON line.

Each takes the JAX script's arguments and prints its lines and JSON
keys, and exposes ``main(argv=None, device=None)``. The device is card 0
unless ``device="cpu"`` is passed or ``RAT_TPU_PLATFORM=cpu`` is set; a
script raises when it finds no card and was not asked for the CPU, and
never carries on elsewhere.
"""

import os
import time

import torch

from ..utils import resolve_device


def script_device(device=None):
    """``device``, or the CPU under ``RAT_TPU_PLATFORM=cpu``, else
    ``cuda:0``; raises for a CUDA device that is not there."""
    if device is None:
        device = "cpu" if os.environ.get("RAT_TPU_PLATFORM") == "cpu" else "cuda:0"
    return resolve_device(device)


def seconds_timer(device):
    """``timed(fn)``: the seconds of ``fn()``, by CUDA events on a card
    (waiting for the work it queued), by the host clock on the CPU."""
    if device.type != "cuda":
        def timed(fn):
            tic = time.perf_counter()
            fn()
            return time.perf_counter() - tic
        return timed

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return timed
