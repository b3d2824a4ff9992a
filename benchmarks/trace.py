"""The traced run's instruments: spans that the harness records around
its calls into each layer, and torch.profiler over a bounded part of the
window, reduced to the device's busy time (the union of its kernel and
copy intervals, so that overlapping streams count once), time by device
operation, and the longest idle gaps named by what the host was doing.

On the card the profiler records the device's activity alone (CUDA
kernels, copies, and the runtime calls that launch them): recording
every host operation as well would cost the host more than the program's
own idle time, and the idle share would measure the profiler. The spans
are the harness's own, taken on the wall clock that the profiler's
timestamps use, and cost a clock read each.

With tracing off, spans are no-ops and nothing is profiled."""

import contextlib
import time

import torch

def _union(intervals):
    """Total length of the union of [start, end) intervals, and the gaps
    between the merged intervals as [(start, end), ...]."""
    busy, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


class Trace(object):
    """One profiled stretch: device intervals, host runtime calls and the
    harness's spans in microseconds of the profiler's clock, and its wall
    time in seconds. ``events`` are the profiler's raw events."""

    def __init__(self, events, wall_s, spans):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        self.device, self.ops = [], []
        for e in events:
            item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            if e.device_type() == cuda and not e.is_user_annotation():
                self.device.append(item)
            elif e.device_type() == cpu:
                self.ops.append(item)
        self.spans = [(s / 1e3, e / 1e3, n) for n, s, e in spans]
        self.wall_s = wall_s
        busy_us, self.gaps = _union([(s, e) for _, s, e in self.device])
        self.busy_s = busy_us / 1e6

    def idle_percent(self):
        """100 * (1 - busy / wall), or None where no device work was seen."""
        if not self.busy_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.wall_s)

    def kernel_time(self, names):
        """(launches, device seconds) of the device operations whose name
        holds any of ``names``."""
        hits = [e - s for n, s, e in self.device if any(k in n for k in names)]
        return len(hits), sum(hits) / 1e6

    def device_ops(self, top=10):
        """The device operations that took most time: [[name, seconds]]."""
        total = {}
        for n, s, e in self.device:
            total[n] = total.get(n, 0.0) + (e - s) / 1e6
        return [[n[:120], t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def _host_at(self, t):
        """What the host was doing at ``t``: the innermost harness span and
        the longest runtime call running then."""
        span = min(((e - s, n) for s, e, n in self.spans if s <= t < e), default=None)
        op = max(((e - s, n) for n, s, e in self.ops if s <= t < e), default=None)
        return "{}: {}".format(span[1] if span else "outside spans",
                               op[1] if op else "host code")

    def idle_gaps(self, top=10):
        """The longest gaps between device work: [[what the host was
        doing, seconds]]."""
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return [[self._host_at((s + e) / 2), (e - s) / 1e6] for s, e in longest]


class Tracer(object):
    """Spans and one profiled stretch of a run. ``enabled`` False makes
    every call a no-op. The profiler's events are read by :meth:`finish`,
    after the window, so that reading them costs the window nothing."""

    def __init__(self, enabled, cuda):
        self.enabled = enabled
        self.cuda = cuda
        self.profiler = None
        self.stopped = None
        self.trace = None
        self.t0 = None
        #: (name, start, end) on the wall clock, in nanoseconds
        self.spans = []
        #: seconds that stopping the profiler took inside the window
        self.stop_s = 0.0

    @contextlib.contextmanager
    def _span(self, name):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))

    def span(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    @property
    def running(self):
        return self.profiler is not None

    @property
    def done(self):
        """Whether a window may close: untraced, or its stretch profiled."""
        return not self.enabled or self.stopped is not None

    def start(self):
        """Start the profiled stretch (once per run): the device's
        activity on the card, the host's on the CPU."""
        if not self.enabled or self.profiler is not None or self.stopped is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.profiler = profile(activities=acts)
        self.profiler.start()
        self.t0 = time.perf_counter()

    def stop(self):
        """End the profiled stretch once the device has finished its work."""
        if self.profiler is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        end = time.perf_counter()
        self.profiler.stop()
        self.stop_s = time.perf_counter() - end
        self.stopped, self.profiler = (self.profiler, end - self.t0), None

    def measured_s(self, window_s):
        """The window's seconds less the profiler's stopping, which
        collects its events and is no work of the program."""
        return window_s - self.stop_s

    def finish(self):
        """Read the stretch's events into ``trace``."""
        self.stop()
        if self.stopped is not None and self.trace is None:
            prof, wall = self.stopped
            self.trace = Trace(prof.profiler.kineto_results.events(), wall, self.spans)
