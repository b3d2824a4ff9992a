"""The reader of ``attn_kernel_share.kkbox``: nothing from a program
without the attention's counters (or without tracing at all), nothing
where no attention ran on the card, and from planted counters the
kernel's share of the calls, eagerly, replayed or captured, forward and
backward, against the plain calls."""

import sys

import pytest

import rat_tpu_torch
from rat_tpu_torch import tracing

from benchmarks import harness
from benchmarks.harness import Run

METRIC = "attn_kernel_share.kkbox"
KEYS = ("attention.launches", "attention.captured", "attention.grad_launches",
        "attention.grad_captured", "attention.plain")


def _read_with(monkeypatch, counters):
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    return harness.reader(METRIC)(Run())


def test_reads_nothing_without_the_counters(monkeypatch):
    # the parent's counters: K1's and the embedding backward's alone
    assert _read_with(monkeypatch, {"cross_intra_block.launches": 7,
                                    "embedding_grad.launches": 4}) is None
    # no attention ran on the card (a CPU run)
    assert _read_with(monkeypatch, dict.fromkeys(KEYS, 0)) is None


def test_reads_nothing_without_tracing(monkeypatch):
    monkeypatch.delattr(rat_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "rat_tpu_torch.tracing", None)
    assert harness.reader(METRIC)(Run()) is None


@pytest.mark.parametrize("counts, share", [
    ((8000, 8, 7992, 8, 0), 100.0),     # a fit: eager, captured and replayed
    ((0, 8, 0, 8, 0), 100.0),           # captured only
    ((30, 0, 10, 0, 40), 50.0),         # half the calls at shapes the kernel refuses
    ((0, 0, 0, 0, 16), 0.0)])           # every call plain
def test_share_from_planted_counters(monkeypatch, counts, share):
    assert _read_with(monkeypatch, dict(zip(KEYS, counts))) == share
