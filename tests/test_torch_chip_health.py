"""The port's GPU health stamp (rat_tpu_torch/cli/chip_health.py) on the
CPU: off CUDA it names the platform with ``healthy: null``, as the JAX
package's stamp does off TPU; the probes run at a tiny size on the CPU
through a stubbed clock, which makes a marginal valid or invalid at
will: a long run that took no longer than the short one is recorded as
invalid (value None, ``probe_valid: false``, ``healthy: false``),
never clamped to 0; the verdict holds each probe to its bound; and an
exception is recorded as ``error``. No timing is asserted."""

import itertools

import pytest
import torch

from rat_tpu_torch.cli import chip_health

TINY = {"roundtrip": (1, 3), "elementwise": (64, 2, 6), "matmul": (16, 1, 3),
        "mhsa": ((8, 4, 10), 2, 4)}
PROBES = ("roundtrip_ms", "kernel_tax_ms", "matmul_tflops", "mhsa_us")


def test_off_cuda_the_stamp_names_the_platform(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    want = {"platform": "cpu", "healthy": None,
            "note": "the device probes run on CUDA only; skipped"}
    assert chip_health.collect() == want
    assert chip_health.collect("cpu") == want


def _stub_marginal(monkeypatch, seconds):
    """_marginal with a clock that gives each run of n repetitions
    ``seconds(n)``."""
    real = chip_health._marginal

    def marginal(run, n_short, n_long, sync, timer, reps=2):
        clock = {"t": 0.0}

        def timed_run(n):
            run(n)
            clock["t"] += seconds(n)

        return real(timed_run, n_short, n_long, sync, lambda: clock["t"], reps)

    monkeypatch.setattr(chip_health, "_marginal", marginal)


def test_valid_marginals_give_each_probe(monkeypatch):
    _stub_marginal(monkeypatch, lambda n: 1e-3 * n)      # 1 ms per repetition
    out = chip_health.verdict(chip_health.probe("cpu", TINY))
    assert out["probe_valid"] is True and out["invalid_probes"] == []
    assert out["roundtrip_ms"] == pytest.approx(1.0)
    assert out["kernel_tax_ms"] == pytest.approx(1.0)
    assert out["matmul_tflops"] == pytest.approx(2 * 16 ** 3 / 1e-3 / 1e12)
    assert out["mhsa_us"] == pytest.approx(1000.0)
    assert out["matmul_tf32"] is False
    # 1 ms per round trip is beyond the healthy bound
    assert out["healthy"] is False and "calibrated_on" in out["healthy_bounds"]


def test_an_invalid_marginal_is_recorded_not_clamped(monkeypatch):
    _stub_marginal(monkeypatch, lambda n: 1.0)        # long runs no longer than short
    out = chip_health.verdict(chip_health.probe("cpu", TINY))
    assert out["probe_valid"] is False and out["healthy"] is False
    assert out["invalid_probes"] == list(PROBES)
    assert all(out[name] is None for name in PROBES)


def test_a_clock_running_backwards_is_invalid():
    ticks = itertools.count(1000, -1)
    out = chip_health.probe("cpu", TINY, timer=lambda: float(next(ticks)))
    assert out["probe_valid"] is False and out["invalid_probes"] == list(PROBES)


def test_healthy_needs_every_probe_within_its_bound():
    good = {"roundtrip_ms": 0.0, "kernel_tax_ms": 0.0, "mhsa_us": 0.0,
            "matmul_tflops": 1e9, "probe_valid": True}
    assert chip_health.verdict(dict(good))["healthy"] is True
    for name, bad in (("roundtrip_ms", 1e9), ("kernel_tax_ms", 1e9), ("mhsa_us", 1e9),
                      ("matmul_tflops", 0.0)):
        assert chip_health.verdict(dict(good, **{name: bad}))["healthy"] is False
    assert chip_health.verdict(dict(good, probe_valid=False))["healthy"] is False


def test_collect_records_an_exception(monkeypatch):
    def broken(device):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(chip_health, "_collect", broken)
    assert chip_health.collect() == {"error": "RuntimeError: probe failed",
                                     "healthy": False}
