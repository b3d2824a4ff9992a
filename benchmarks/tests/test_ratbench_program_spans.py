"""The split of the device's idle time by the program's own spans
(benchmarks/program_spans.py) on a synthetic trace, the readers of the
metrics built on it, a program without spans, and a traced rehearsal
that reads the program's retrieval spans."""

import sys

import pytest
import torch

import rat_tpu_torch

from benchmarks import harness, program_spans
from benchmarks.harness import Run
from benchmarks.tests.helpers import rehearse
from benchmarks.trace import Trace
from rat_tpu_torch.tracing import Span

US = 1000   # nanoseconds in a microsecond


class _Event(object):
    """What Trace reads of a profiler event, on the card's device."""

    def __init__(self, name, start_us, end_us):
        self._name, self._start, self._end = name, start_us * US, end_us * US

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False


def _trace(busy, wall_s):
    """A Trace whose device worked over ``busy`` [(start, end)] in
    microseconds: its gaps lie between them."""
    return Trace([_Event("kernel", s, e) for s, e in busy], wall_s, [])


def _spans(*items):
    """Spans from (name, start, end[, parent[, counts]]), times in
    microseconds."""
    out = []
    for name, start, end, *rest in items:
        parent = rest[0] if rest else None
        counts = rest[1] if len(rest) > 1 else {}
        out.append(Span(name, start * US, end * US, parent, counts))
    return out


#: A [0, 100) holds B [10, 40) and C [50, 60); D [120, 150) stands alone
SPANS = _spans(("A", 0, 100), ("B", 10, 40, 0), ("C", 50, 60, 0), ("D", 120, 150))
#: device work around the gaps (5, 15), (35, 55), (90, 130), (160, 170)
BUSY = [(0, 5), (15, 35), (55, 90), (130, 160), (170, 200)]


def _run(trace, spans, **kw):
    run = Run(tracer=type("T", (), {"trace": trace})(), **kw)
    run.program_spans = spans
    return run


def test_innermost_pieces():
    assert program_spans.innermost(SPANS) == [
        (0, 10, "A"), (10, 40, "B"), (40, 50, "A"), (50, 60, "C"), (60, 100, "A"),
        (120, 150, "D")]


def test_idle_split_sums_to_the_gaps():
    trace = _trace(BUSY, 200e-6)
    assert trace.gaps == [(5, 15), (35, 55), (90, 130), (160, 170)]
    idle = program_spans.idle_by_span(trace.gaps, SPANS)
    assert idle == {"A": 25, "B": 10, "C": 5, "D": 10, None: 30}
    assert sum(idle.values()) == sum(e - s for s, e in trace.gaps)


def test_idle_split_of_spans_out_of_order_and_gaps_outside_them():
    spans = [SPANS[3], SPANS[2], SPANS[0], SPANS[1]]
    idle = program_spans.idle_by_span([(300, 310), (5, 15)], spans)
    assert idle == {"A": 5, "B": 5, None: 10}


def test_self_time():
    assert program_spans.self_ns(SPANS) == [60 * US, 30 * US, 10 * US, 30 * US]


def test_idle_percent_over_the_wall():
    run = _run(_trace(BUSY, 200e-6), SPANS)
    assert program_spans.idle_percent(run, ("A", "C")) == pytest.approx(100.0 * 30 / 200)
    assert program_spans.idle_percent(run, ("E",)) == 0.0
    assert program_spans.idle_percent(_run(_trace(BUSY, 200e-6), []), ("A",)) is None
    assert program_spans.idle_percent(_run(None, SPANS), ("A",)) is None
    assert program_spans.idle_percent(_run(_trace([], 1.0), SPANS), ("A",)) is None


def _read(metric, run):
    return harness.reader(metric)(run)


def test_retrieval_readers():
    # one fold of a 2-fold pass: the fold holds its pool, the IDF, the
    # packing, the upload, the scan and the collection
    spans = _spans(("retrieval.fold", 0, 100), ("retrieval.fold_pool", 0, 10, 0),
                   ("bm25.idf", 10, 30, 0), ("bm25.idf_pack", 30, 40, 0, {"bytes": 1000}),
                   ("bm25.upload", 40, 50, 0, {"bytes": 3_000_000}),
                   ("bm25.scan", 50, 90, 0, {"calls": 2}),
                   ("bm25.collect", 90, 100, 0, {"bytes": 80}))
    busy = [(0, 2), (45, 92), (100, 110)]
    cfg = {"dataset": {"retrieval": {"split_type": "2-fold"}}}
    run = _run(_trace(busy, 110e-6), spans, cfg=cfg)
    assert _read("idf_idle.retrieve", run) == pytest.approx(100.0 * 30 / 110)
    assert _read("pool_idle.retrieve", run) == pytest.approx(100.0 * (8 + 5 + 8) / 110)
    assert _read("h2d_mb.retrieve", run) == pytest.approx(2 * 3.001)
    total = sum(e - s for s, e in run.tracer.trace.gaps)
    shares = [_read(m, run) for m in ("idf_idle.retrieve", "pool_idle.retrieve")]
    assert sum(shares) == pytest.approx(100.0 * total / 110)
    assert run.tracer.trace.idle_percent() == pytest.approx(100.0 * total / 110)


def test_train_readers():
    spans = _spans(("train.epoch", 0, 200), ("train.group", 0, 100, 0),
                   ("train.step", 0, 20, 1), ("graph.capture.train", 20, 30, 1),
                   ("graph.replay.train", 30, 35, 1), ("train.optim", 35, 45, 1),
                   ("graph.replay.train", 45, 50, 1), ("train.optim", 50, 56, 1),
                   ("eval", 100, 190, 0), ("eval.dispatch", 100, 120, 8),
                   ("graph.capture.eval", 105, 110, 9), ("eval.drain", 120, 150, 8),
                   ("eval.metrics", 150, 180, 8), ("train.checkpoint", 190, 200, 0))
    busy = [(0, 1), (19, 21), (40, 100), (118, 140), (199, 200)]
    run = _run(_trace(busy, 200e-6), spans)
    # dispatch: 1-19 train.step, 21-40 capture, replay, optim
    assert _read("dispatch_idle.train", run) == pytest.approx(100.0 * 37 / 200)
    # evaluation: 100-118 dispatch and capture, 140-199
    assert _read("eval_idle.train", run) == pytest.approx(100.0 * 77 / 200)
    assert _read("optim_host_ms.train", run) == pytest.approx((10 + 6) / 2 / 1e3)
    assert _read("optim_host_ms.train", _run(None, spans[:3])) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A checkout older than the program's tracing module: the readers
    report nothing and raise nothing."""
    monkeypatch.delattr(rat_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "rat_tpu_torch.tracing", None)
    run = Run(tracer=type("T", (), {"trace": _trace(BUSY, 200e-6)})(),
              cfg={"dataset": {"retrieval": {"split_type": "10-fold"}}})
    for metric in ("idf_idle.retrieve", "pool_idle.retrieve", "h2d_mb.retrieve",
                   "dispatch_idle.train", "optim_host_ms.train", "eval_idle.train"):
        assert _read(metric, run) is None


def test_traced_rehearsal_reads_the_programs_retrieval_spans():
    """On the CPU the trace holds no device work, so the idle shares are
    left out; the bytes the program uploads per pass are read."""
    rc, last, err = rehearse("mltag-retrieve", extra=["--trace", "1"])
    assert rc == 0, err[-3000:]
    metrics = last["metrics"]
    assert "idf_idle.retrieve" not in metrics and "pool_idle.retrieve" not in metrics
    # each of 10 folds uploads its pool (9/10 of 9,000 rows) and queries,
    # 3 int32 fields, and its IDF tables
    assert metrics["h2d_mb.retrieve"]["value"] > 4 * 3 * 9000 * 10 / 1e6
    assert metrics["h2d_mb.retrieve"]["unit"] == "MB"
