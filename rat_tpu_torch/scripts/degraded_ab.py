"""Quick A/B of train-step throughput knobs.

Runs the bench's ML-Tag train step (``cli/benchmark.py::_bench_setup``)
in short windows and prints one line of examples/s, so that candidate
settings (batch size, model overrides) compare in minutes. A window is
``group`` steps in a Python loop (the port has no grouped dispatch):
the first window's seconds are printed as ``compile`` (the first steps'
one-time costs: cuBLAS handles, the allocator's first blocks, the
optimizer's build), then ``steps // group`` windows are timed three
times.

    python -m rat_tpu_torch.scripts.degraded_ab [batch_size] [group] [steps]

Defaults 4096, 64, 128. RAT_AB_OVERRIDE can hold a JSON dict of
model-param overrides (e.g. '{"dnn_hidden_units": [], "depth": 1}'),
applied by the bench's ``bench_params``. ``impl`` and ``xla_flags`` are
printed as the environment holds them (RAT_TPU_ENCODER_IMPL,
XLA_FLAGS), so that the line reads like the JAX script's; neither
changes anything on a card. Runs on card 0 (``RAT_TPU_PLATFORM=cpu`` or
``device="cpu"`` for the CPU).
"""

import os
import sys
import time

from ..cli.benchmark import _bench_setup
from . import script_device


def main(argv=None, device=None, n_rows=200_000):
    argv = sys.argv[1:] if argv is None else list(argv)
    B = int(argv[0]) if len(argv) > 0 else 4096
    group = int(argv[1]) if len(argv) > 1 else 64
    steps = int(argv[2]) if len(argv) > 2 else 128
    device = script_device(device)

    trainer, data, idx, _ = _bench_setup("mltag", batch_size=B, n_rows=n_rows,
                                         device=device)
    idx_group = [idx[i % len(idx)] for i in range(group)]

    def window():
        for i in idx_group:
            loss = trainer.train_step(data, i, B)
        return float(loss)  # waits for the window's last step

    tic = time.perf_counter()
    window()
    compile_s = time.perf_counter() - tic
    for _ in range(max(1, 64 // group) - 1):
        window()

    rates = []
    for _ in range(3):
        tic = time.perf_counter()
        for _ in range(max(1, steps // group)):
            window()
        n = max(1, steps // group) * group * B
        rates.append(n / (time.perf_counter() - tic))
    line = (f"B={B} group={group} impl={os.environ.get('RAT_TPU_ENCODER_IMPL', 'auto')} "
            f"xla_flags={os.environ.get('XLA_FLAGS', '')!r} compile={compile_s:.1f}s "
            f"rates={[f'{r / 1e3:.0f}k' for r in rates]} best={max(rates) / 1e3:.0f}k ex/s "
            f"({1e3 * B / max(rates):.2f} ms/step)")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
