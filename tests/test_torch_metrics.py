"""The port's AUC and logloss (scipy ranks, no sklearn) against
rat_tpu.metrics (sklearn), within 1e-12, with heavy ties."""

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
