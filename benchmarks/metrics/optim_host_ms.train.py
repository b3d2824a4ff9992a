"""The host's milliseconds per replayed train step in the optimizer's
eager step after the replay: the mean self time of the program's
``train.optim`` spans in the profiled stretch of training."""

from benchmarks import program_spans


def read(run):
    found = program_spans.spans(run)
    own = program_spans.self_ns(found)
    optim = [own[i] for i, s in enumerate(found) if s.name == "train.optim"]
    if not optim:
        return None
    return sum(optim) / len(optim) / 1e6
