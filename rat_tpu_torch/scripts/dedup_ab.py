"""A/B of the ``dedup_neighbors`` flag.

The flag gathers each batch's pool rows once per distinct row and
expands them with the inverse index (engine/trainer.py::_gather_batch),
on the theory that deduplicating the repeating neighbour ids cuts the
traffic of a sharded step. Two measurements decide whether it stays:

  --hlo   one sharded train step with the flag off and on, on a world of
          8 gloo ranks on the CPU (4 data x 2 model, the JAX script's
          8-device mesh), started as the CLI starts its own ranks
          (parallel/distributed.py::launch). The port has no compiled
          program to read, so each rank records the torch.distributed
          collectives the step issues, by kind and output bytes, by
          wrapping the module's functions (the trainer and the sharded
          lookup call them as ``dist.<op>``). Prints the profile keyed
          ``dedup=False`` / ``dedup=True`` (``collectives``,
          ``collective_out_bytes``; the JAX script's ``hlo_lines`` has
          no counterpart), then ``collective profile identical: <bool>``.
  --time  ML-Tag bench steps (cli/benchmark.py::_bench_setup) with the
          flag off and on, on the device: after one warm window of 64
          steps, the best of 3 windows of 256; one JSON line of
          examples/s.

    python -m rat_tpu_torch.scripts.dedup_ab --hlo | --time

Runs on card 0 (``RAT_TPU_PLATFORM=cpu`` or ``device="cpu"`` for the
CPU); ``--hlo`` always runs its ranks on the CPU, as the JAX script
always compiled for its virtual CPU devices.
"""

import argparse
import contextlib
import json
import multiprocessing
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..cli.benchmark import _bench_setup
from ..engine import Trainer
from ..features import FeatureMap
from ..parallel import launch, make_mesh
from . import script_device

#: torch.distributed function -> the collective's kind (XLA's names);
#: each function's first argument is its output
COLLECTIVES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "all_gather_into_tensor": "all-gather", "all_to_all": "all-to-all",
               "all_to_all_single": "all-to-all", "reduce_scatter": "reduce-scatter",
               "reduce_scatter_tensor": "reduce-scatter", "broadcast": "broadcast"}


def _nbytes(out):
    if torch.is_tensor(out):
        return out.numel() * out.element_size()
    return sum(_nbytes(t) for t in out)


@contextlib.contextmanager
def recording_collectives():
    """Inside, every collective of COLLECTIVES called through
    ``torch.distributed`` is recorded before it runs; yields the list
    of (kind, process group or None, output bytes)."""
    calls, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.append((COLLECTIVES[name], kwargs.get("group"), _nbytes(args[0])))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _feature_map():
    fm = FeatureMap("dedup_ab", ".")
    fm.feature_specs = {
        "user_id": {"source": "", "type": "categorical", "vocab_size": 61000, "index": 0},
        "item_id": {"source": "", "type": "categorical", "vocab_size": 17000, "index": 1},
        "tag_id": {"source": "", "type": "categorical", "vocab_size": 12000, "index": 2}}
    fm.num_fields, fm.num_features, fm.input_length = 3, 90000, 3
    return fm


def _params(dedup):
    return {"model": "RAT_m2", "model_id": "ab", "model_root": "./exps/ab/",
            "embedding_dim": 10, "dnn_hidden_units": [64, 64], "dnn_activations": "relu",
            "num_heads": 2, "dim_head": 10, "depth": 2, "scale_dim": 4,
            "dropout": 0., "emb_dropout": 0., "net_dropout": 0.,
            "batch_norm": False, "use_wide": True,
            "embedding_regularizer": 0.03, "net_regularizer": 0,
            "learning_rate": 1e-3, "optimizer": "adam", "seed": 2021,
            "metrics": ["AUC"], "dedup_neighbors": dedup}


def collective_profile(mesh, dedup):
    """One train step (loss, backward, clip, Adam) of the JAX script's
    sharded model on this rank of ``mesh``, with ``dedup_neighbors``
    off or on, at its shapes (B=64, K=5, 4096 rows). Every rank must
    call it. Returns ({"collectives": {kind: count},
    "collective_out_bytes": n}, the step's global loss, the calls as
    (kind, group, bytes))."""
    B, K, N = 64, 5, 4096
    rng = np.random.RandomState(0)
    tr = Trainer(_feature_map(), _params(dedup), mesh=mesh)
    tokens = np.stack([rng.randint(0, 61000, N), rng.randint(0, 17000, N),
                       rng.randint(0, 12000, N)], axis=1)
    labels = rng.rand(N).astype(np.float32)
    pool_labels = rng.rand(N).astype(np.float32)
    nbr = rng.randint(0, N, (N, K))
    idx = rng.randint(0, N, B)
    dev = mesh.device
    tokens = torch.from_numpy(tokens).to(dev)
    data = {"tokens": tokens, "labels": torch.from_numpy(labels).to(dev),
            "pool_tokens": tokens, "pool_labels": torch.from_numpy(pool_labels).to(dev),
            "nbr": torch.from_numpy(nbr).to(dev)}
    with recording_collectives() as calls:
        loss = float(tr.train_step(data, torch.from_numpy(idx).to(dev), B))
    counts = {}
    for kind, _, _ in calls:
        counts[kind] = counts.get(kind, 0) + 1
    return ({"collectives": counts,
             "collective_out_bytes": sum(n for _, _, n in calls)}, loss, calls)


def _audit_worker(n_devices, model_axis, results):
    mesh = make_mesh(n_devices, model_axis)
    out = {}
    for dedup in (False, True):
        out["dedup=%s" % dedup] = collective_profile(mesh, dedup)[0]
    if mesh.rank == 0:
        results.put(out)


def collective_audit(n_devices=8, model_axis=2):
    """The collective profile of one sharded train step with the flag
    off and on, on ``n_devices`` gloo ranks (``model_axis`` of them per
    model group); prints it and whether the two are identical."""
    results = multiprocessing.get_context("spawn").SimpleQueue()
    launch(_audit_worker, ["cpu"] * n_devices, (n_devices, model_axis, results))
    out = results.get()
    print(json.dumps(out, indent=2))
    same = out["dedup=False"] == out["dedup=True"]
    print("collective profile identical:", same, flush=True)
    return out, same


def time_ab(device, steps=256, group=64, batch_size=4096, n_rows=200_000):
    """Examples/s of the ML-Tag bench step with the flag off and on, in
    grouped dispatches of ``group`` steps (``Trainer.train_scan``; each
    arm prints its dispatch, ``Trainer.train_dispatch``: on a card both
    replay the step graph, on the CPU both step eagerly): one warm
    window of ``group`` steps, then the best of 3 windows of ``steps``.
    The flag reaches the bench's params through RAT_AB_OVERRIDE, which
    is restored afterwards."""
    before = os.environ.get("RAT_AB_OVERRIDE")
    rates = {}
    try:
        for dedup in (False, True):
            if dedup:
                os.environ["RAT_AB_OVERRIDE"] = json.dumps({"dedup_neighbors": True})
            else:
                os.environ.pop("RAT_AB_OVERRIDE", None)
            trainer, data, idx, B = _bench_setup("mltag", batch_size=batch_size,
                                                 n_rows=n_rows, device=device)
            idx_group = torch.stack([idx[i % len(idx)] for i in range(group)])
            print("dedup={} dispatch: {}".format(dedup, trainer.train_dispatch(group)),
                  flush=True)

            def window(n):
                for _ in range(n // group):
                    loss = trainer.train_scan(data, idx_group, [B] * group)[-1]
                return float(loss)  # waits for the window's last step

            window(group)
            best = 0.0
            for _ in range(3):
                tic = time.perf_counter()
                window(steps // group * group)
                best = max(best, steps // group * group * B / (time.perf_counter() - tic))
            rates["dedup=%s" % dedup] = round(best, 1)
            del trainer, data
    finally:
        if before is None:
            os.environ.pop("RAT_AB_OVERRIDE", None)
        else:
            os.environ["RAT_AB_OVERRIDE"] = before
    print(json.dumps(rates), flush=True)
    return rates


def main(argv=None, device=None, **time_sizes):
    """``time_sizes``: ``time_ab``'s steps, group, batch_size, n_rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hlo", action="store_true")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args(argv)
    device = script_device(device)
    out = {}
    if args.hlo:
        out["hlo"] = collective_audit()
    if args.time:
        out["time"] = time_ab(device, **time_sizes)
    return out


if __name__ == "__main__":
    main()
