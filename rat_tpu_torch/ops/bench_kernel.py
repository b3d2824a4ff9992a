"""Microbenchmark: kernel K1 (the fused cross/intra block) against the
plain block (``nn.encoders.CrossIntraEncoderBlock``, the counterpart of
the JAX package's XLA path) at the ML-Tag training shape: B=4096,
t=1+5, s=F+1=4, d=10, 2 heads x 10, hidden 40.

    python -m rat_tpu_torch.ops.bench_kernel

Prints, for each, microseconds per block call and million samples per
second (CUDA events over 50 calls after a warm-up), then the largest
absolute difference of their outputs and the largest absolute output. Runs on card 0 and raises
without one.
"""

import numpy as np
import torch

from ..models.fast_forward import _block_params
from ..nn.encoders import CrossIntraEncoderBlock
from ..utils import resolve_device
from . import cross_intra_block as k1


def _us_per_call(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


@torch.no_grad()
def main(device=None, reps=50):
    """Times both at the ML-Tag shape; returns {name: us per call} and
    the largest difference."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_kernel times the CUDA kernel: it needs a card")
    d, heads, dim_head, hidden = 10, 2, 10, 40
    B, t, s = 4096, 6, 4
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(B, t, s, d).astype(np.float32)).to(device)
    block = CrossIntraEncoderBlock(d, heads, dim_head, hidden,
                                   generator=torch.Generator().manual_seed(0))
    block = block.to(device).eval()
    params = _block_params(block)
    fns = {"plain": lambda: block(x),
           "cuda_k1": lambda: k1.cross_intra_block(x, params, heads, dim_head)}
    times = {}
    for name, fn in fns.items():
        times[name] = _us_per_call(fn, reps)
        print("{}: {:.1f} us/block  ({:.1f}M samples/s)".format(
            name, times[name], B / times[name]))
    want = fns["plain"]()
    diff = float((want - fns["cuda_k1"]()).abs().max())
    print("max diff: {} (largest |output| {})".format(diff, float(want.abs().max())))
    return times, diff


if __name__ == "__main__":
    main()
