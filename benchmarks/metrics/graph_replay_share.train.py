"""Share of the window's train steps that replayed the step's CUDA graph
(``StepGraph.replays``, read by the harness as the Trainer drops each
graph). The rest ran eagerly: each graph's first batch, and the per-step
batches before an evaluation boundary that do not fill a group."""


def read(run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    return 100.0 * run.counters["train_replays"] / steps
