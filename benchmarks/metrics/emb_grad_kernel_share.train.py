"""Share of the embedding lookups' backward calls on the card that ran
the hand-written kernel, over the whole run, from the program's counters
(``rat_tpu_torch.tracing.counters()``: ``embedding_grad.launches``, eager
calls and replayed ones, and ``.captured``). Every such call runs the
kernel (``ops/embedding_grad.py`` refuses a dtype it does not take), so
this reads 100.0 wherever one ran: it says that the kernel is on the
path. A program without these counters, or a run in which no backward
ran on the card, reports nothing."""

KEYS = ("embedding_grad.launches", "embedding_grad.captured")


def read(run):
    try:
        from rat_tpu_torch import tracing
    except ImportError:
        return None
    counters = getattr(tracing, "counters", dict)()
    if not all(key in counters for key in KEYS):
        return None
    return 100.0 if counters[KEYS[0]] + counters[KEYS[1]] else None
