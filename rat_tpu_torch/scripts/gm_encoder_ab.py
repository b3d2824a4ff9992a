"""A/B prototype: the CrossIntraEncoder on a fixed [t, s, d, b] layout.

The module encoder (nn/encoders.py::CrossIntraEncoder) alternates intra
and cross attention by transposing the stream ((b t) s d <-> (b s) t d)
between them, and each attention moves its heads to a batch axis and
back. ``encoder_gm`` evaluates the SAME parameters (the module's state
dict) on one layout, [t, s, d, b] with the batch minor, end to end:
intra and cross attention differ only in the axis their reduction runs
over, and the stream is transposed once on entry and once on exit.

The reduces are ``torch.einsum`` over that layout, not the JAX script's
broadcast products: eager PyTorch would materialise each product before
its sum, [t, s, d, 3, h, c, b] for the QKV projection alone, 236 MB at
ML-Tag width (t=6, s=4, d=10, 2 heads x 10, b=4096) and 13 GB at KKBox
width (s=14, d=40, 8 heads x 10).

    python -m rat_tpu_torch.scripts.gm_encoder_ab [--depth 4] [--b 4096] [--parity]

Prints one JSON line: with ``--parity`` the forward's largest absolute
error and the largest per-leaf relative gradient error against the
module encoder, then the forward+backward time of ``sum(out ** 2)`` for
both (min over ``--trials``, each call on a salted input; CUDA events on
a card, the host clock on the CPU). Runs on card 0; ``--platform cpu``
(or ``RAT_TPU_PLATFORM=cpu``, or ``device="cpu"``) selects the CPU.
"""

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.encoders import CrossIntraEncoder
from . import script_device, seconds_timer


def _ln(x, scale, bias, eps=1e-5):
    """LayerNorm over d for x [t, s, d, b]."""
    m = x.mean(dim=2, keepdim=True)
    v = ((x - m) ** 2).mean(dim=2, keepdim=True)
    return (x - m) * (scale[:, None] / torch.sqrt(v + eps)) + bias[:, None]


def _dense(x, weight, bias):
    """x [t, s, d, b] through an ``nn.Linear`` weight [e, d] -> [t, s, e, b]."""
    return torch.einsum("tsdb,ed->tseb", x, weight) + bias[:, None]


def _attention_gm(x, p, heads, dim_head, over_t):
    """Pre-norm MHSA on x [t, s, d, b] over the t axis (cross) or the s
    axis (intra); the math of PreNormAttention. ``p(name)`` reads the
    parameter ``<attention>.<name>``."""
    h = _ln(x, p("norm.weight"), p("norm.bias"))
    d = x.shape[2]
    wqkv = p("attn.to_qkv.weight").reshape(3, heads, dim_head, d)
    qkv = torch.einsum("tsdb,khcd->tskhcb", h, wqkv)          # [t, s, 3, h, c, b]
    q, k, v = qkv.unbind(2)                                    # [t, s, h, c, b]
    scale = dim_head ** -0.5
    if over_t:
        dots = torch.einsum("ishcb,jshcb->ijshb", q, k) * scale
        out = torch.einsum("ijshb,jshcb->ishcb", torch.softmax(dots, dim=1), v)
    else:
        dots = torch.einsum("tihcb,tjhcb->tijhb", q, k) * scale
        out = torch.einsum("tijhb,tjhcb->tihcb", torch.softmax(dots, dim=2), v)
    wo = p("attn.to_out.weight").reshape(d, heads, dim_head)
    return torch.einsum("tshcb,ehc->tseb", out, wo) + p("attn.to_out.bias")[:, None]


def encoder_gm(state, x, heads, dim_head, depth):
    """CrossIntraEncoder forward on the [t, s, d, b] layout: x [b, t, s, d]
    in and out, ``state`` the module's state dict (``blocks.{i}....``)."""
    h = x.permute(1, 2, 3, 0)
    for i in range(depth):
        def p(name, i=i):
            return state["blocks.{}.{}".format(i, name)]
        h = _attention_gm(h, lambda n: p("intra_attention." + n), heads, dim_head,
                          over_t=False) + h
        h = _attention_gm(h, lambda n: p("cross_attention." + n), heads, dim_head,
                          over_t=True) + h
        ff = F.gelu(_dense(h, p("mlp.fc1.weight"), p("mlp.fc1.bias")), approximate="none")
        h = _dense(ff, p("mlp.fc2.weight"), p("mlp.fc2.bias")) + h
    return h.permute(3, 0, 1, 2)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=4096)
    ap.add_argument("--t", type=int, default=6)
    ap.add_argument("--s", type=int, default=4)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--dim-head", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--scale-dim", type=int, default=4)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--parity", action="store_true",
                    help="also check the forward and gradients against the module")
    ap.add_argument("--platform", default=None, help="cpu to run on the CPU")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    args = _args(argv)
    device = script_device(device or args.platform)
    b, t, s, d = args.b, args.t, args.s, args.d
    enc = CrossIntraEncoder(d, args.heads, args.dim_head, args.depth, args.scale_dim * d,
                            generator=torch.Generator().manual_seed(0)).to(device)
    rng = np.random.RandomState(0)
    x0 = torch.from_numpy(rng.randn(b, t, s, d).astype(np.float32)).to(device)

    def loss_ref(x):
        return (enc(x) ** 2).sum()

    def loss_gm(x):
        return (encoder_gm(dict(enc.named_parameters()), x, args.heads, args.dim_head,
                           args.depth) ** 2).sum()

    def step(loss_fn, x):
        enc.zero_grad(set_to_none=True)
        loss = loss_fn(x)
        loss.backward()
        return loss.detach()

    def grads(loss_fn, x):
        step(loss_fn, x)
        return [p.grad.detach().clone() for p in enc.parameters()]

    fwd_err = g_err = None
    if args.parity:
        with torch.no_grad():
            y_ref = enc(x0)
            y_gm = encoder_gm(dict(enc.named_parameters()), x0, args.heads,
                              args.dim_head, args.depth)
        fwd_err = float((y_ref - y_gm).abs().max())
        g_ref, g_gm = grads(loss_ref, x0), grads(loss_gm, x0)
        rel = [float((a - b2).abs().max() / (a.abs().max() + 1e-12))
               for a, b2 in zip(g_ref, g_gm)]
        g_err = max(rel)

    timed = seconds_timer(device)

    def bench(loss_fn):
        salt = [x0 * (1 + 1e-6 * i) for i in range(args.trials + 1)]
        float(step(loss_fn, salt[0]))
        return min(timed(lambda: step(loss_fn, salt[i + 1])) for i in range(args.trials))

    t_ref = bench(loss_ref)
    t_gm = bench(loss_gm)
    res = {"shape": [b, t, s, d], "depth": args.depth,
           "fwd_max_abs_err": fwd_err, "grad_max_abs_err": g_err,
           "ref_ms": round(t_ref * 1e3, 3), "gm_ms": round(t_gm * 1e3, 3),
           "speedup": round(t_ref / t_gm, 3)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
