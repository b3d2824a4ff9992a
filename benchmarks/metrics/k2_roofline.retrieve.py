"""K2 (BM25 score and top-K: its scan and merge kernels) against its
roofline over the one retrieval pass that the traced run profiles: the
least time of each of the pass's calls, from the fold sizes, summed, over
K2's device time in the pass."""

from benchmarks import yardstick

K2 = ("bm25_scan_kernel", "bm25_merge_kernel")


def read(run):
    trace = run.tracer.trace
    if trace is None:
        return None
    launches, seconds = trace.kernel_time(K2)
    if not launches:
        return None
    rc = run.cfg["dataset"]["retrieval"]
    calls = yardstick.fold_calls(len(run.splits["train"]), rc)
    return 100.0 * yardstick.k2_bound_s(calls, len(rc["used_cols"]), rc["topK"]) / seconds
