"""The port's metrics (scipy ranks, no sklearn) against rat_tpu.metrics
(sklearn), within 1e-12: AUC and logloss with heavy ties, and the
grouped GAUC, NDCG, MRR and HitRate on tests/test_metrics.py's cases."""

import numpy as np
import pytest

from rat_tpu import metrics as jm
from rat_tpu_torch import metrics as tm


@pytest.mark.parametrize("levels", [3, 17, 0])
def test_auc_and_logloss_match_sklearn(levels):
    rng = np.random.RandomState(levels)
    y = (rng.rand(5000) < 0.3).astype(np.float64)
    p = rng.rand(5000)
    if levels:
        p = np.round(p * levels) / levels        # many ties, 0 and 1 included
    want = jm.evaluate_metrics(y, p, ["AUC", "logloss"])
    got = tm.evaluate_metrics(y, p, ["AUC", "logloss"])
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_auc_single_class_raises():
    with pytest.raises(ValueError):
        tm.AUC(np.ones(4), np.linspace(0, 1, 4))


def test_group_metrics_match_jax_on_hand_case():
    """tests/test_metrics.py's two groups: one ranked right, one inverted."""
    y = np.array([1, 0, 0, 0, 1, 0], dtype=float)
    p = np.array([0.9, 0.5, 0.1, 0.9, 0.5, 0.1])
    g = np.array([0, 0, 0, 1, 1, 1])
    assert tm.GAUC(y, p, g) == pytest.approx(0.75, abs=1e-12)
    for name, kw in (("GAUC", {}), ("NDCG", {}), ("MRR", {}), ("HitRate", {"k": 1}),
                     ("NDCG", {"k": 2}), ("HitRate", {})):
        want = getattr(jm, name)(y, p, g, **kw)
        assert abs(getattr(tm, name)(y, p, g, **kw) - want) <= 1e-12, name


@pytest.mark.parametrize("seed,n,groups,levels", [(0, 40, 5, 0), (1, 500, 30, 10),
                                                  (2, 2000, 7, 3)])
def test_group_metrics_via_evaluate_match_jax(seed, n, groups, levels):
    """Random labels, scores (rounded for ties) and groups, through
    evaluate_metrics with a group_index, as tests/test_metrics.py."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n).astype(np.float64)
    p = rng.rand(n)
    if levels:
        p = np.round(p * levels) / levels
    g = rng.randint(0, groups, n)
    metrics = ["GAUC", "NDCG", "MRR", "HitRate", "AUC", "logloss"]
    want = jm.evaluate_metrics(y, p, metrics, group_index=g)
    got = tm.evaluate_metrics(y, p, metrics, group_index=g)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_group_metrics_need_a_group_index():
    with pytest.raises(ValueError, match="group_index"):
        tm.evaluate_metrics(np.ones(4), np.linspace(0, 1, 4), ["GAUC"])
