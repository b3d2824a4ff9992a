"""The program's own spans in a traced run, and the device's idle time
split by them.

rat_tpu_torch records its spans (rat_tpu_torch.tracing) while
torch.profiler runs, so what it holds after a traced run are the spans
of the profiled stretch, on the wall clock that the profiler's events
use. Each gap of the trace (the device idle between two of its
intervals) is put down, instant by instant, to the innermost program
span open then; what no span covers stays unattributed. A program
without spans (one older than the tracing module) gives none, and the
readers then report nothing."""


def spans(run):
    """The spans that rat_tpu_torch recorded in the run, taken from it
    once and kept on the run; [] where it records none."""
    if getattr(run, "program_spans", None) is None:
        try:
            from rat_tpu_torch import tracing
        except ImportError:
            run.program_spans = []
        else:
            run.program_spans = tracing.take()
    return run.program_spans


def self_ns(found):
    """Each span's duration less its recorded children's, in ns."""
    out = [s.end_ns - s.start_ns for s in found]
    for s in found:
        if s.parent is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def innermost(found):
    """[(start, end, name)] in microseconds, in order: the stretches of
    time during which each span was the innermost one open. The spans
    nest, as one thread's do."""
    pieces, stack, t = [], [], None
    for s in sorted(found, key=lambda s: (s.start_ns, -s.end_ns)):
        start, end = s.start_ns / 1e3, s.end_ns / 1e3
        while stack and stack[-1][0] <= start:
            end_top, name = stack.pop()
            pieces.append((t, end_top, name))
            t = end_top
        if stack:
            pieces.append((t, start, stack[-1][1]))
            end = min(end, stack[-1][0])
        stack.append((end, s.name))
        t = start
    while stack:
        end_top, name = stack.pop()
        pieces.append((t, end_top, name))
        t = end_top
    return [p for p in pieces if p[1] > p[0]]


def idle_by_span(gaps, found):
    """{span name: microseconds} of the ``gaps`` [(start, end)] in
    microseconds during which that span was the innermost one open, and
    under None the microseconds of the gaps that no span covers."""
    pieces = innermost(found)
    out, total, i = {}, 0.0, 0
    for start, end in sorted(gaps):
        total += end - start
        while i < len(pieces) and pieces[i][1] <= start:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < end:
            lo, hi, name = pieces[j]
            overlap = min(hi, end) - max(lo, start)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
            j += 1
    out[None] = total - sum(out.values())
    return out


def idle_percent(run, names):
    """The share of the profiled stretch's wall time during which the
    device idled while the innermost program span was one of ``names``;
    None without a trace, device work or program spans."""
    trace = run.tracer.trace
    found = spans(run)
    if trace is None or not trace.busy_s or not found:
        return None
    idle = idle_by_span(trace.gaps, found)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / 1e6 / trace.wall_s
