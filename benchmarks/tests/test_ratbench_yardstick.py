"""The yardstick's counts against hand counts and against the formulas
of chip_smoke.py, from which they were copied."""

import os

import pytest

import chip_smoke
from benchmarks import harness, yardstick
from benchmarks.tests.helpers import ROOT

CFG = harness.load_json(os.path.join(ROOT, "benchmarks", "configs", "rat_m2-mltag.json"))


def test_block_shape_of_mltag():
    assert yardstick.block_shape(CFG) == (6, 4, 10, 2, 10, 40, True)


def test_k1_flops_by_hand():
    # per sample: 24 tokens; intra (L=4) and cross (L=6) attention each
    # 2*24*10*60 (QKV) + 4*24*L*20 (scores, values) + 5*24*L*2 (softmax)
    # + 8*24*10 (LayerNorm) + 2*24*20*10 (out); FF 4*24*10*40 + 10*24*40
    intra = 28800 + 4 * 24 * 4 * 20 + 5 * 24 * 4 * 2 + 1920 + 9600
    cross = 28800 + 4 * 24 * 6 * 20 + 5 * 24 * 6 * 2 + 1920 + 9600
    assert yardstick.k1_flops(*yardstick.block_shape(CFG)) == intra + cross + 38400 + 9600


@pytest.mark.parametrize("shape", [(6, 4, 10, 2, 10, 40, True), (6, 14, 40, 8, 10, 80, True),
                                   (6, 4, 10, 1, 10, 40, False), (3, 5, 16, 2, 8, 64, True)])
def test_k1_flops_equal_chip_smoke(shape):
    assert yardstick.k1_flops(*shape) == chip_smoke.k1_flops(*shape)


def test_k1_bytes_by_hand():
    # input and output 2 * B * 6 * 4 * 10 floats; weights: 2 LayerNorms
    # (2 * 10 each), 2 QKV (60 x 10), 2 out (10 x 20 + 10), FF (40 x 10
    # + 40 + 10 x 40 + 10)
    weights = 2 * (20 + 600 + 210) + 400 + 40 + 400 + 10
    assert yardstick.k1_bytes(4096, *yardstick.block_shape(CFG)) == \
        2 * 4096 * 240 * 4 + weights * 4


def test_forward_flops_per_example_by_hand():
    dnn = 2 * (30 * 400 + 400 * 400 + 400 * 400 + 400 * 1)
    assert yardstick.forward_flops_per_example(CFG) == \
        4 * yardstick.k1_flops(6, 4, 10, 2, 10, 40, True) + 2 * 10 + dnn + 3
    assert yardstick.train_flops_per_example(CFG) == \
        3 * yardstick.forward_flops_per_example(CFG)


def test_bound_equals_chip_smoke():
    for ops, nbytes in ((1e12, 1e9), (1e9, 1e12), (2.5e11, 5e8)):
        ms, _ = chip_smoke._bound(ops, nbytes)
        assert yardstick.bound_s(ops, nbytes) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_k2_counts_by_hand():
    assert yardstick.k2_ops(5000, 1264320, 3) == 2 * 5000 * 1264320 * 3
    assert yardstick.k2_bytes(5000, 1264320, 3, 5) == \
        3 * 1264320 * 4 + 5000 * 3 * 8 + 5000 * 5 * 8


def test_fold_calls_of_mltag():
    rc = CFG["dataset"]["retrieval"]
    n = CFG["dataset"]["rows"]["train"]
    calls = yardstick.fold_calls(n, rc)
    assert len(calls) == chip_smoke._fold_k2_batches(n, chip_smoke.MLTAG_RETRIEVAL) == 290
    assert sum(q for q, _ in calls) == n
    fold = -(-n // 10)
    assert {p for _, p in calls[:29]} == {n - fold} and sum(q for q, _ in calls[:29]) == fold
    assert yardstick.pool_calls(200686, n, rc)[-1] == (200686 - 40 * 5000, n)
