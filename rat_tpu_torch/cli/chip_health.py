"""GPU health stamp (the port's counterpart of rat_tpu.cli.chip_health).

    python -m rat_tpu_torch.cli.chip_health      # one JSON line

A benchmark number taken on a card that is throttled, shared or slow to
answer should say so. Four probes, each a MARGINAL cost (the time of a
long run of the same work minus a short one, divided by the extra
work), so that the fixed cost of starting and ending a timing cancels:

- ``roundtrip_ms``: one scalar kernel and its ``.item()`` (the host
  waits for the card and reads the value back), 11 against 1;
- ``kernel_tax_ms``: one elementwise pass over 8 MB of float32 (a
  launch and 16 MB of traffic), 200 passes against 20;
- ``matmul_tflops``: float32 matmul rate from 9 against 1 chained
  8192 x 8192 products, with TF32 off at the port's default
  ``RAT_TPU_MATMUL_PRECISION`` (float32) and on under a reduced one
  (``matmul_tf32`` in the stamp says which);
- ``mhsa_us``: the port's ``nn.layers.mhsa`` at the JAX probe's shape
  ([24576, 4, 10], 2 heads), 60 calls against 10.

A marginal whose long run took no longer than its short one says
nothing: it is recorded in ``invalid_probes``, its value is None, and
the stamp has ``probe_valid: false`` and ``healthy: false`` (it is not
clamped to 0). The stamp also carries the card's name and power limit
as ``nvidia-smi`` gives them. Off CUDA the probes do not run: the
stamp names the platform and has ``healthy: null``. ``collect()``
records an exception as ``error`` and never raises.
"""

import json
import subprocess
import time

import torch

from ..nn.layers import mhsa

# Healthy bounds, from four stamps taken one after another on an idle
# NVIDIA H100 80GB HBM3 at 700 W, before any other work in that process
# tree (PERF.md §6): round trip 0.0207-0.0309 ms, elementwise pass
# 0.0094-0.0237 ms, float32 matmul 51.68-51.72 TFLOP/s, mhsa 194-214 us.
# Each bound allows 3x the slowest idle reading (a third of the rate).
HEALTHY = {"roundtrip_ms": 0.09, "kernel_tax_ms": 0.07, "matmul_tflops": 17.0,
           "mhsa_us": 640.0}
HEALTHY_ON = "NVIDIA H100 80GB HBM3, 700.00 W"

# (short, long) repetition counts and sizes of the four probes
FULL = {"roundtrip": (1, 11), "elementwise": (2 * 1024 * 1024, 20, 200),
        "matmul": (8192, 1, 9), "mhsa": ((24576, 4, 10), 10, 60)}


def nvidia_smi():
    """``name, power.limit`` of card 0 as nvidia-smi prints them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def _marginal(run, n_short, n_long, sync, timer, reps=2):
    """(seconds per extra repetition, or None when the long run was not
    longer) from the best of ``reps`` timings of ``run(n)``, each ending
    in a sync, after one untimed run of each length."""
    def timed(n):
        sync()
        t0 = timer()
        run(n)
        sync()
        return timer() - t0

    timed(n_short), timed(n_long)
    t_short = min(timed(n_short) for _ in range(reps))
    t_long = min(timed(n_long) for _ in range(reps))
    if not t_long > t_short:
        return None
    return (t_long - t_short) / (n_long - n_short)


def probe(device, sizes=FULL, timer=time.perf_counter):
    """Run the four probes on ``device`` at ``sizes``; returns the
    probe fields of the stamp and ``probe_valid``."""
    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    salt = torch.tensor(1.0 + 1e-7, device=device)
    out, invalid = {}, []

    def record(name, per_rep, scale):
        if per_rep is None:
            invalid.append(name)
            out[name] = None
        else:
            out[name] = scale(per_rep)

    s = torch.zeros((), device=device)

    def roundtrip(n):
        for _ in range(n):
            (s + 1.0).item()

    record("roundtrip_ms", _marginal(roundtrip, *sizes["roundtrip"], sync, timer),
           lambda t: t * 1e3)

    numel, short, long = sizes["elementwise"]
    x0 = torch.ones(numel, device=device)

    def passes(n):
        x = x0
        for _ in range(n):
            x = x * salt
        x[0].item()

    record("kernel_tax_ms", _marginal(passes, short, long, sync, timer),
           lambda t: t * 1e3)

    dim, short, long = sizes["matmul"]
    a = torch.ones((dim, dim), device=device)

    def chain(n):
        y = a * salt
        for _ in range(n):
            y = y @ a
        y[0, 0].item()

    record("matmul_tflops", _marginal(chain, short, long, sync, timer),
           lambda t: 2 * dim ** 3 / t / 1e12)

    shape, short, long = sizes["mhsa"]
    q0 = torch.ones(shape, device=device)

    def attn(n):
        c = q0
        for _ in range(n):
            c = mhsa(c * salt, c, c, heads=2, scale=0.3)
        c[0, 0, 0].item()

    record("mhsa_us", _marginal(attn, short, long, sync, timer), lambda t: t * 1e6)
    out["matmul_tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    out["invalid_probes"] = invalid
    out["probe_valid"] = not invalid
    return out


def verdict(out):
    """Set ``healthy`` (and the bounds used) on a stamp with probes."""
    ok = out["probe_valid"] and (
        out["roundtrip_ms"] < HEALTHY["roundtrip_ms"]
        and out["kernel_tax_ms"] < HEALTHY["kernel_tax_ms"]
        and out["matmul_tflops"] > HEALTHY["matmul_tflops"]
        and out["mhsa_us"] < HEALTHY["mhsa_us"])
    out["healthy"] = bool(ok)
    out["healthy_bounds"] = dict(HEALTHY, calibrated_on=HEALTHY_ON)
    return out


def _collect(device):
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type, "healthy": None,
                "note": "the device probes run on CUDA only; skipped"}
    out = {"platform": "gpu", "device": torch.cuda.get_device_name(device),
           "nvidia_smi": nvidia_smi()}
    out.update(probe(device))
    return verdict(out)


def collect(device=None):
    """The stamp of ``device`` (None: card 0 when there is one). Never
    raises: an exception is recorded as ``error``."""
    try:
        return _collect(device)
    except Exception as e:
        return {"error": "{}: {}".format(type(e).__name__, e)[:200], "healthy": False}


def main():
    print(json.dumps(collect()))


if __name__ == "__main__":
    main()
