"""One run of one cell of BENCHMARK.json:

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness finds everything by name. The cell names its configuration
(``configs/<config>.json``, through BENCHMARK.json's ``configs``) and its
traffic (``traffic/<traffic>.json``), which names its runner
(``runners/<runner>.py``); each per-layer metric is read by
``metrics/<metric>.py``; each number compared has its limit in
``limits/<cell>.json``. A later cell adds files and entries and edits
none.

A run makes its inputs and weights from ``--seed``, sets up and warms up
(``setup_s``, from the process's start), measures for ``--seconds``,
reads the device's peak memory, checks that nothing of JAX or of the JAX
package was loaded, frees the program's state, holds what the timed path
produced to the plain reference, and prints one JSON line last, with the
numbers compared and their limits under ``checks`` (and as the last lines
of standard error). ``--trace 1`` profiles a stretch of the window and
reports the per-layer metrics instead of the end-to-end ones.

Without a CUDA card, or with fewer cards than the cell asks for, a run
fails. ``--rehearse-cpu`` runs the cell on the CPU at the tiny sizes of
its configuration's ``rehearsal`` block, with the kernels' plain
versions, to rehearse paths, shapes and the last line; its numbers are
CPU numbers and say nothing of the card. ``--control`` makes the same
run, but the reference computed in the precision below the
configuration's takes the place of what the program produced, and the
numbers compared go through the same limits: the control's line has to
read ``correct`` false.
"""

import argparse
import importlib
import importlib.util
import json
import os
import re
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "rat_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def banned_modules():
    """The banned top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _by_name(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit("no {} named {!r} in BENCHMARK.json".format(what, name))


def _file(kind, name, ext):
    if not _NAME.match(name):
        raise SystemExit("{} name {!r} is not a name".format(kind, name))
    return os.path.join(HERE, kind, name + ext)


def applies(metric, cell):
    """Whether ``metric`` is read in ``cell``."""
    return cell in metric.get("workloads", [cell])


def resolve(cell_name, spec=None):
    """(spec, cell, configuration, traffic, limits) of a cell, each found
    by its name."""
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = _by_name(spec["workloads"], cell_name, "workload")
    entry = _by_name(spec["configs"], cell["config"], "configuration")
    cfg = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(_file("traffic", cell["traffic"], ".json"))
    path = _file("limits", cell_name, ".json")
    limits = load_json(path) if os.path.exists(path) else {}
    return spec, cell, cfg, traffic, limits


def runner(traffic):
    name = traffic["runner"]
    _file("runners", name, ".py")
    return importlib.import_module("benchmarks.runners." + name)


def reader(metric):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = _file("metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics._" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run(object):
    """What a run knows: its cell, configuration, traffic, seeds and
    device, what its runner sets up, and what the window measured
    (``e2e``, ``counters``, ``attempted``, ``failed``; ``tracer.trace``
    in a traced run)."""

    def __init__(self, **kw):
        self.e2e, self.counters = {}, {}
        self.attempted = self.failed = 0
        self.trainer = None
        self.__dict__.update(kw)


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU at the configuration's rehearsal sizes")
    ap.add_argument("--control", action="store_true",
                    help="judge the reference in the precision below in the "
                         "program's place")
    return ap.parse_args(argv)


def _environment(cfg):
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels into build/kernels/ there), and the
    product precision the configuration states."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    os.environ["RAT_TPU_MATMUL_PRECISION"] = cfg["matmul_precision"]


def _device(torch, cell, rehearse):
    if rehearse:
        return "cpu", {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card "
                         "(--rehearse-cpu rehearses it on the CPU)")
    if torch.cuda.device_count() < cell["chips"]:
        raise SystemExit("the cell asks for {} cards, {} are present".format(
            cell["chips"], torch.cuda.device_count()))
    return "cuda:0", {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"]}


def _metrics(spec, run, trace):
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones that find something to read."""
    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if applies(m, run.cell["name"]):
                value = run.setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in spec["per_layer"]:
        if applies(m, run.cell["name"]):
            value = reader(m["name"])(run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _refuse_banned(when):
    found = banned_modules()
    if found:
        raise SystemExit("loaded {} {}: the benchmark must not load JAX or the JAX "
                         "package".format(", ".join(found), when))


def main(argv, t_start):
    args = parse(argv)
    spec, cell, cfg, traffic, limits = resolve(args.workload)
    _environment(cfg)
    sys.path.insert(0, ROOT)
    import torch

    from . import data
    from .reference import strict_float32
    from .trace import Tracer

    device, dev_info = _device(torch, cell, args.rehearse_cpu)
    cuda = device != "cpu"
    stretch = traffic["trace"]
    if args.rehearse_cpu:
        stretch = traffic.get("rehearsal", {}).get("trace", stretch)
    tmp = tempfile.mkdtemp(prefix="ratbench-")
    run = Run(cell=cell, cfg=cfg, traffic=traffic, seeds=data.seeds(args.seed),
              device=device, rehearse=args.rehearse_cpu, control=args.control,
              tmp=tmp, tracer=Tracer(bool(args.trace), cuda), traffic_trace=stretch)
    drive = runner(traffic)
    try:
        drive.setup(run)
        if cuda:
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - t_start
        drive.window(run, args.seconds)
        run.tracer.stop()
        if cuda:
            dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        _refuse_banned("by the close of the window")
        strict_float32()
        readings = drive.check(run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _refuse_banned("in the run")
    run.tracer.finish()
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": _metrics(spec, run, args.trace), "device": dev_info}
    trace = run.tracer.trace
    if args.trace and trace is not None:
        dev_info["busy_s"] = trace.busy_s
        dev_info["window_s"] = trace.wall_s
        line["breakdown"] = {"device_ops": trace.device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["counters"] = run.counters
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print("check {}: {!r} limit {!r}".format(name, c["value"], c["limit"]),
              file=sys.stderr)
    print("{}correct: {}".format("control: " if args.control else "", correct),
          file=sys.stderr, flush=True)
    return 0
