"""The share of the profiled stretch of training during which the card
idled while the host was in the evaluation (innermost program span
``eval``, ``eval.dispatch``, ``eval.drain``, ``eval.metrics``,
``graph.capture.eval``, ``graph.replay.eval`` or ``train.checkpoint``):
its dispatch, the copy back, the host's AUC and logloss, and the
checkpoint that follows it."""

from benchmarks import program_spans

SPANS = ("eval", "eval.dispatch", "eval.drain", "eval.metrics", "graph.capture.eval",
         "graph.replay.eval", "train.checkpoint")


def read(run):
    return program_spans.idle_percent(run, SPANS)
