"""Share of the block's backward calls on the card that ran K1's
backward kernel rather than autograd of the plain block, over the whole
run: 100 x (grad_launches + grad_captured) / (grad_launches +
grad_captured + grad_plain), from the program's counters
(``rat_tpu_torch.tracing.counters()``, under ``cross_intra_block.``).
A program without these counters reports nothing."""

KEYS = ("cross_intra_block.grad_launches", "cross_intra_block.grad_captured",
        "cross_intra_block.grad_plain")


def read(run):
    try:
        from rat_tpu_torch import tracing
    except ImportError:
        return None
    counters = getattr(tracing, "counters", dict)()
    if not all(key in counters for key in KEYS):
        return None
    kernel = counters[KEYS[0]] + counters[KEYS[1]]
    total = kernel + counters[KEYS[2]]
    return 100.0 * kernel / total if total else None
