"""The reader of ``emb_grad_kernel_share.train``: nothing from a program
without the embedding backward's counters (or without tracing at all),
nothing where no backward ran on the card, and 100.0 from planted
counters wherever the kernel ran, eagerly, replayed or captured."""

import sys

import pytest

import rat_tpu_torch
from rat_tpu_torch import tracing

from benchmarks import harness
from benchmarks.harness import Run

METRIC = "emb_grad_kernel_share.train"


def _read_with(monkeypatch, counters):
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    return harness.reader(METRIC)(Run())


def test_reads_nothing_without_the_counters(monkeypatch):
    # the parent's counters: K1's alone
    assert _read_with(monkeypatch, {"cross_intra_block.launches": 7,
                                    "cross_intra_block.grad_plain": 4}) is None
    # no lookup's backward ran on the card (a CPU run)
    assert _read_with(monkeypatch, {"embedding_grad.launches": 0,
                                    "embedding_grad.captured": 0}) is None


def test_reads_nothing_without_tracing(monkeypatch):
    monkeypatch.delattr(rat_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "rat_tpu_torch.tracing", None)
    assert harness.reader(METRIC)(Run()) is None


@pytest.mark.parametrize("launches, captured", [(2700, 12), (30, 0), (0, 5)])
def test_share_from_planted_counters(monkeypatch, launches, captured):
    assert _read_with(monkeypatch, {"embedding_grad.launches": launches,
                                    "embedding_grad.captured": captured}) == 100.0
