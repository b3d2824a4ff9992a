"""The program's spans and counters, on the clock that torch.profiler's
event timestamps use (``time.time_ns()``), so that a span and the device
activity a profile records share one timeline.

- ``span(name, **counts)`` is a context manager. A recorded span keeps
  its name, start and end in nanoseconds, its parent (the span open
  around it) and integer ``counts`` given at entry or added inside it
  (``with span("bm25.upload", bytes=n)``; ``s.add(bytes=n)``). A span's
  self time is its duration less its children's.
- ``count(name, n=1)`` adds to a counter that lives as long as the
  process; ``counters()`` returns them, with the kernels' own launch
  counters under their modules' names (``cross_intra_block.launches``,
  ``.captured``, ``.grad_launches``, ``.grad_captured``, ``.grad_plain``,
  ``embedding_grad.launches``, ``.captured``, ``attention.launches``,
  ``.captured``, ``.grad_launches``, ``.grad_captured``, ``.plain``,
  ``bm25_topk.launches``), which count whether or not anything records.
- Recording is off by default. It is on while a torch.profiler session
  runs (``torch.autograd.profiler._is_profiler_enabled``), and between
  :func:`enable` and :func:`disable`. Off, a span or count site costs a
  flag read and returns one shared null context.
- Spans stay in memory, the most recent ``MAX_SPANS`` of them; older
  ones are dropped and counted (:func:`dropped`). :func:`take` returns
  the finished spans and clears them.

Nothing here writes a file or waits for the device. The spans of one
process come from one thread and close in the order they opened (no
span is left open across a ``yield``): the stack of open spans is not
shared between threads.

The names the program records (the benchmark's readers and the
``profile_dir`` export read them):

- retrieval (data/loader.py, retrieval/bm25.py): ``retrieval.fold``
  (one per fold of an X-fold self-retrieval), ``retrieval.fold_pool``,
  ``bm25.prepare``, ``bm25.idf``, ``bm25.idf_pack`` (``bytes``),
  ``bm25.upload`` (``bytes``), ``bm25.scan`` (``calls``),
  ``bm25.collect`` (``bytes``), ``retrieval.remap``;
- training (engine/trainer.py, engine/step_graph.py): ``train.epoch``,
  ``train.device_split`` (``bytes``), ``train.group``, ``train.step``,
  ``graph.capture.<kind>``, ``graph.replay.<kind>``, ``train.optim``,
  ``train.checkpoint``; counters ``graph.captures.<kind>``,
  ``graph.replays.<kind>``, ``train.eager_steps``, and
  ``model.path.fused`` / ``model.path.module``: one count per train
  step, eager or replayed, by the path its forward took (K1's fused
  path, or the module encoder);
- evaluation: ``eval``, ``eval.dispatch``, ``eval.drain``,
  ``eval.metrics``.
"""

import collections
import time

from torch.autograd import profiler as _profiler

#: finished and open spans kept in memory before the oldest are dropped
MAX_SPANS = 1 << 20

#: one finished span as :func:`take` returns it: ``parent`` is the index
#: of the enclosing span in the same list, or None where that span was
#: not recorded or was taken before
Span = collections.namedtuple("Span", ["name", "start_ns", "end_ns", "parent", "counts"])


class _Null(object):
    """What a site gets while nothing records: enters, exits and adds
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


_NULL = _Null()


class _Open(object):
    """A span being recorded."""

    __slots__ = ("recorder", "seq", "name", "start_ns", "end_ns", "parent", "counts")

    def __init__(self, recorder, name, counts):
        self.recorder, self.name, self.counts = recorder, name, counts
        self.end_ns = None

    def __enter__(self):
        rec = self.recorder
        self.parent = rec._stack[-1].seq if rec._stack else None
        self.seq = rec._seq = rec._seq + 1
        if len(rec._spans) == rec.max_spans:
            rec._dropped += 1
        rec._spans.append(self)
        rec._stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self.recorder._stack.pop()
        return False

    def add(self, **counts):
        """Add integer counts to the span."""
        for key, n in counts.items():
            self.counts[key] = self.counts.get(key, 0) + n


class Recorder(object):
    """Spans and counters of one process (the module's functions use one
    shared Recorder); ``max_spans`` bounds the spans kept."""

    def __init__(self, max_spans=MAX_SPANS):
        self.max_spans = max_spans
        self._on = False
        self._spans = collections.deque(maxlen=max_spans)
        self._stack = []
        self._seq = 0
        self._dropped = 0
        self._counts = {}

    def recording(self):
        """Whether spans and counts are recorded now."""
        return self._on or _profiler._is_profiler_enabled

    def enable(self):
        self._on = True

    def disable(self):
        self._on = False

    def span(self, name, **counts):
        """A context that records ``name`` while recording is on; the
        shared null context otherwise."""
        if not (self._on or _profiler._is_profiler_enabled):
            return _NULL
        return _Open(self, name, counts)

    def count(self, name, n=1):
        """Add ``n`` to the counter ``name`` while recording is on."""
        if not (self._on or _profiler._is_profiler_enabled):
            return
        self._counts[name] = self._counts.get(name, 0) + n

    def counters(self):
        """A snapshot of the counters, the kernels' launch counters
        included."""
        from .ops import attention, bm25_topk, cross_intra_block, embedding_grad
        out = dict(self._counts)
        out.update({"cross_intra_block.launches": cross_intra_block.launches,
                    "cross_intra_block.captured": cross_intra_block.captured,
                    "cross_intra_block.grad_launches": cross_intra_block.grad_launches,
                    "cross_intra_block.grad_captured": cross_intra_block.grad_captured,
                    "cross_intra_block.grad_plain": cross_intra_block.grad_plain,
                    "embedding_grad.launches": embedding_grad.launches,
                    "embedding_grad.captured": embedding_grad.captured,
                    "bm25_topk.launches": bm25_topk.launches,
                    "attention.launches": attention.launches,
                    "attention.captured": attention.captured,
                    "attention.grad_launches": attention.grad_launches,
                    "attention.grad_captured": attention.grad_captured,
                    "attention.plain": attention.plain})
        return out

    def dropped(self):
        """Spans dropped for the bound since the last :meth:`take`."""
        return self._dropped

    def take(self):
        """The finished spans in the order they started, as
        :class:`Span`; they are cleared, and spans still open stay for a
        later take."""
        done = [s for s in self._spans if s.end_ns is not None]
        self._spans = collections.deque((s for s in self._spans if s.end_ns is None),
                                        maxlen=self.max_spans)
        self._dropped = 0
        where = {s.seq: i for i, s in enumerate(done)}
        return [Span(s.name, s.start_ns, s.end_ns, where.get(s.parent), dict(s.counts))
                for s in done]


_recorder = Recorder()
recording = _recorder.recording
enable = _recorder.enable
disable = _recorder.disable
span = _recorder.span
count = _recorder.count
counters = _recorder.counters
dropped = _recorder.dropped
take = _recorder.take


def chrome_events(spans, base_ns=0, pid=0, tid=0):
    """``spans`` (from :func:`take`) as Chrome trace events (``ph`` "X",
    microseconds from ``base_ns``, the ``baseTimeNanoseconds`` of the
    profiler trace they go beside), their counts under ``args``."""
    return [{"name": s.name, "ph": "X", "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": tid,
             "args": s.counts} for s in spans]
