"""Profile the benchmark train step and print a device-time table by
kernel.

The bench program (``cli/benchmark.py::_bench_setup(shape)``, the step
``bench_train`` measures) runs two warm windows and then two windows
under torch.profiler, each window ``group`` train steps in a Python
loop (the port has no grouped ``lax.scan`` dispatch; a window is the
same steps one by one). The CUDA kernels' device time is summed by
kernel name; the total and the top 45 kernels print with their share,
as the JAX script's table of XLA ops does. On the CPU the table is of
the CPU operators' own time instead.

    python -m rat_tpu_torch.scripts.profile_train_step [shape] [group] [impl]

``shape`` is mltag (default), kkbox or tmall; ``group`` defaults to 64.
``impl`` selects ``RAT_TPU_ENCODER_IMPL`` in the JAX script, a TPU
layout that the port's model accepts and ignores: it is accepted here
the same way, and the script prints that it was ignored. Runs on card 0
(``RAT_TPU_PLATFORM=cpu`` or ``device="cpu"`` for the CPU).
"""

import sys

import torch
from torch.profiler import ProfilerActivity, profile

from ..cli.benchmark import _bench_setup
from . import script_device


def kernel_table(prof, device):
    """[(name, us)] from ``prof``, largest first, and the total us: CUDA
    kernels and copies by device time on a card (user annotations left
    out, they span kernels counted already), CPU operators by their own
    time on the CPU."""
    per_op = {}
    for e in prof.key_averages():
        if device.type == "cuda":
            if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
                continue
            us = e.self_device_time_total
        else:
            if e.device_type != torch.autograd.DeviceType.CPU or e.is_user_annotation:
                continue
            us = e.self_cpu_time_total
        per_op[e.key] = per_op.get(e.key, 0.0) + us
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])
    return ranked, sum(per_op.values())


def main(argv=None, device=None, batch_size=4096, n_rows=200_000):
    argv = sys.argv[1:] if argv is None else list(argv)
    shape = argv[0] if len(argv) > 0 else "mltag"
    group = int(argv[1]) if len(argv) > 1 else 64
    device = script_device(device)
    if len(argv) > 2:
        print("impl={} ignored: the port's encoder has one layout".format(argv[2]))

    trainer, data, idx, B = _bench_setup(shape, batch_size=batch_size, n_rows=n_rows,
                                         device=device)
    idx_group = [idx[i % len(idx)] for i in range(group)]

    def window():
        for i in idx_group:
            loss = trainer.train_step(data, i, B)
        return float(loss)  # waits for the window's last step

    for _ in range(2):
        window()
    # the device's activity only on a card: recording every CPU operator
    # of 2 x group steps costs more than the steps themselves
    activities = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        for _ in range(2):
            window()
    ranked, total = kernel_table(prof, device)
    what = "CUDA kernels" if device.type == "cuda" else "CPU operators' own time"
    print(f"{shape} group={group}: {2 * group} steps profiled; total accounted "
          f"{total / 1e3:.2f} ms ({what} only)")
    for name, us in ranked[:45]:
        print(f"{us:12.1f} us  {100 * us / max(total, 1e-9):5.2f}%  {name[:110]}")
    return ranked, total


if __name__ == "__main__":
    main()
