"""The card's idle share over the traced run's profiled stretch of
training (``Trace.idle_percent``), the device's activity alone recorded."""


def read(run):
    trace = run.tracer.trace
    return None if trace is None else trace.idle_percent()
