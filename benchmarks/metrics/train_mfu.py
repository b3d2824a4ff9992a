"""The training step's share of the card's float32 peak: the model's
FLOPs per example (the forward's times 3) times the traced run's
examples per second over its window, less the profiler's stopping."""

from benchmarks import yardstick


def read(run):
    examples = run.counters.get("examples")
    if run.device == "cpu" or not examples:
        return None
    rate = examples / run.tracer.measured_s(run.counters["window_s"])
    return 100.0 * yardstick.train_flops_per_example(run.cfg) * rate \
        / yardstick.PEAK_F32_FLOPS
