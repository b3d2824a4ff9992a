"""The reader of ``k1_grad_kernel_share.train``: nothing from a program
without the backward's counters (or without tracing at all), nothing
where no backward ran on the card, and the kernel's share of the
backward calls from planted counters."""

import sys

import pytest

import rat_tpu_torch
from rat_tpu_torch import tracing

from benchmarks import harness
from benchmarks.harness import Run

METRIC = "k1_grad_kernel_share.train"


def _read_with(monkeypatch, counters):
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    return harness.reader(METRIC)(Run())


def test_reads_nothing_without_the_counters(monkeypatch):
    # the parent's counters: K1's forward ones alone
    assert _read_with(monkeypatch, {"cross_intra_block.launches": 7,
                                    "cross_intra_block.captured": 4}) is None
    # no backward ran on the card (a CPU run)
    assert _read_with(monkeypatch, {"cross_intra_block.grad_launches": 0,
                                    "cross_intra_block.grad_captured": 0,
                                    "cross_intra_block.grad_plain": 0}) is None


def test_reads_nothing_without_tracing(monkeypatch):
    monkeypatch.delattr(rat_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "rat_tpu_torch.tracing", None)
    assert harness.reader(METRIC)(Run()) is None


@pytest.mark.parametrize("launches, captured, plain, share", [
    (900, 4, 0, 100.0), (30, 10, 10, 80.0), (0, 0, 5, 0.0)])
def test_share_from_planted_counters(monkeypatch, launches, captured, plain, share):
    assert _read_with(monkeypatch, {"cross_intra_block.grad_launches": launches,
                                    "cross_intra_block.grad_captured": captured,
                                    "cross_intra_block.grad_plain": plain}) \
        == pytest.approx(share)
