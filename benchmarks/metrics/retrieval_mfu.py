"""The retrieval pass's share of the card's float32 peak: the dense
scan's operations (a compare and an add per query, pool row and field,
over every fold's calls) times the passes of the traced run's window,
over the window less the profiler's stopping."""

from benchmarks import yardstick


def read(run):
    passes = run.counters.get("passes")
    if run.device == "cpu" or not passes:
        return None
    rc = run.cfg["dataset"]["retrieval"]
    n_fields = len(rc["used_cols"])
    ops = sum(yardstick.k2_ops(q, n, n_fields)
              for q, n in yardstick.fold_calls(len(run.splits["train"]), rc))
    seconds = run.tracer.measured_s(run.counters["window_s"])
    return 100.0 * ops * passes / seconds / yardstick.PEAK_F32_FLOPS
