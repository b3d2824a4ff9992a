"""Share of the traced stretch's train steps whose forward took the
module encoder rather than K1's fused path: 100 x model.path.module /
(model.path.module + model.path.fused), from the program's counters
(``rat_tpu_torch.tracing.counters()``), which count each train step,
eager or replayed, while the profiler runs. A program without these
counters, or a stretch without a train step, reports nothing."""

KEYS = ("model.path.module", "model.path.fused")


def read(run):
    try:
        from rat_tpu_torch import tracing
    except ImportError:
        return None
    counters = getattr(tracing, "counters", dict)()
    module, fused = (counters.get(key, 0) for key in KEYS)
    total = module + fused
    return 100.0 * module / total if total else None
