"""The share of the profiled stretch of training during which the card
idled while the host was in the train dispatch (innermost program span
``train.epoch``, ``train.device_split``, ``train.group``, ``train.step``,
``graph.capture.train``, ``graph.replay.train`` or ``train.optim``): the
per-step batches, each graph's eager first batch and capture, the
replays, the eager optimizer step and the index uploads."""

from benchmarks import program_spans

SPANS = ("train.epoch", "train.device_split", "train.group", "train.step",
         "graph.capture.train", "graph.replay.train", "train.optim")


def read(run):
    return program_spans.idle_percent(run, SPANS)
