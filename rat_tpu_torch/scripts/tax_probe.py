"""Marginal cost per op class at the bench's train-step shape.

Times the marginal cost of one op of each family in the RAT_m2 step at
the bench shape ([t=6, s=4, d=10, b=4096], the JAX script's layout):
plain elementwise (4-D against a flat control), LayerNorm over d, the
QKV and output projections, the attention core, a relayout of b to the
major axis and back, and the embedding gather and scatter-add of 73,728
ids into a 90,000 x 10 table. Marginal = (time of 48 chained reps -
time of 8 reps) / 40, the best of 3 of each, timed with CUDA events on
a card, so that launch latency and fixed costs cancel.

    python -m rat_tpu_torch.scripts.tax_probe

In PyTorch: the projection and attention reduces are ``torch.einsum``
over the [t, s, ..., b] layout (a broadcast product, which XLA fuses,
would materialise a [t, s, d, 3, h, c, b] tensor in eager PyTorch); the
gather is ``index_select`` and the scatter-add ``index_add_`` in place
(the JAX ``.at[ids].add``); eager PyTorch has no simplifier to cancel a
transpose pair, so ``transpose_rt`` needs no barrier, but each
transpose is made real with ``contiguous()`` (an elementwise op on a
permuted view keeps the view's strides and would move nothing). Runs on
card 0 (``RAT_TPU_PLATFORM=cpu`` or ``device="cpu"`` for the CPU, host
clock).
"""

import argparse

import numpy as np
import torch

from . import script_device, seconds_timer


def cases(device, b=4096):
    """[(name, op, its first argument)] at the bench shape with batch b."""
    t, s, d = 6, 4, 10
    V, h, c = 90_000, 2, 10
    rng = np.random.RandomState(0)

    def tensor(a):
        return torch.from_numpy(a).to(device)

    x0 = tensor(rng.rand(t, s, d, b).astype(np.float32))
    flat0 = tensor(rng.rand(t * s * d * b).astype(np.float32))
    table0 = tensor(rng.rand(V, d).astype(np.float32))
    ids0 = tensor(rng.randint(0, V, 73728).astype(np.int64))
    wqkv = tensor(rng.rand(d, 3, h, c).astype(np.float32) * 0.1)
    wout = tensor(rng.rand(h, c, d).astype(np.float32) * 0.1)
    ones = torch.full((len(ids0), d), 1e-9, device=device)

    def ew(x):
        return x * 1.0000001 + 1e-7

    def ln(x):
        m = x.mean(dim=2, keepdim=True)
        v = ((x - m) ** 2).mean(dim=2, keepdim=True)
        return (x - m) * torch.rsqrt(v + 1e-5)

    def qkv(x):
        return torch.einsum("tsdb,dkhc->tskhcb", x, wqkv)       # [t,s,3,h,c,b]

    def out_proj(o):
        return torch.einsum("tshcb,hcd->tsdb", o, wout)

    def qkv_roundtrip(x):
        return out_proj(qkv(x)[:, :, 0])

    def attn_core(x):
        q, k, v = qkv(x).unbind(2)
        dots = torch.einsum("tihcb,tjhcb->tijhb", q, k) * (c ** -0.5)
        attn = torch.softmax(dots, dim=2)
        return out_proj(torch.einsum("tijhb,tjhcb->tihcb", attn, v))

    def transpose_rt(x):
        y = x.permute(3, 0, 1, 2).contiguous() * 1.0000001
        return y.permute(1, 2, 3, 0).contiguous()

    def gather(tab):
        g = tab.index_select(0, ids0)                            # [73728, d]
        return tab + g.sum() * 1e-12

    def scatter(tab):
        return tab.index_add_(0, ids0, ones)

    return [
        ("ew_grid      [6,4,10,4096]", ew, x0),
        ("ew_flat      [983040]", ew, flat0),
        ("layernorm    axis=d", ln, x0),
        ("qkv+out_proj reduces", qkv_roundtrip, x0),
        ("attention    core fwd", attn_core, x0),
        ("transpose_rt b<->major", transpose_rt, x0),
        ("gather+redux 73728xd", gather, table0),
        ("scatter_add  73728xd", scatter, table0),
    ]


def main(argv=None, device=None, b=4096, reps=(8, 48)):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    device = script_device(device)
    timed = seconds_timer(device)

    def run(f, arg, n):
        def prog(salt):
            a = arg + salt
            for _ in range(n):
                a = f(a)
            return a

        prog(1e-9)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return min(timed(lambda: prog(1e-9 * (i + 2))) for i in range(3))

    short, long = reps
    print(f"{'case':<30} {'us/op':>10}  (marginal, {long} vs {short} reps)")
    out = {}
    for name, f, arg in cases(device, b):
        per = (run(f, arg, long) - run(f, arg, short)) / (long - short) * 1e6
        out[name] = per
        print(f"{name:<30} {per:>10.1f}", flush=True)
    return out


if __name__ == "__main__":
    main()
