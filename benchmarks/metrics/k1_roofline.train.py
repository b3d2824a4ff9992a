"""K1 (the fused encoder block) against its roofline in the profiled
stretch of training: the least time of one launch over a batch, from
the configuration's shapes, over K1's mean device time per launch. The
block's backward is autograd of its plain version and is not K1."""

from benchmarks import yardstick

K1 = ("cross_intra_block",)


def read(run):
    trace = run.tracer.trace
    if trace is None:
        return None
    launches, seconds = trace.kernel_time(K1)
    if not launches:
        return None
    return 100.0 * yardstick.k1_bound_s(run.cfg, run.batch) * launches / seconds
