"""Share of the module encoder's attention calls on the card that ran the
hand-written kernel, forward and backward, over the whole run, from the
program's counters (``rat_tpu_torch.tracing.counters()``):
100 x (``attention.launches`` + ``.captured`` + ``.grad_launches`` +
``.grad_captured``) / (those + ``attention.plain``), ``plain`` counting
the calls on the card that took the plain version because the kernel
does not take their shape. A program without these counters, or a run
in which no attention ran on the card, reports nothing."""

KERNEL = ("attention.launches", "attention.captured", "attention.grad_launches",
          "attention.grad_captured")
PLAIN = "attention.plain"


def read(run):
    try:
        from rat_tpu_torch import tracing
    except ImportError:
        return None
    counters = getattr(tracing, "counters", dict)()
    if not all(key in counters for key in KERNEL + (PLAIN,)):
        return None
    kernel = sum(counters[key] for key in KERNEL)
    total = kernel + counters[PLAIN]
    return 100.0 * kernel / total if total else None
