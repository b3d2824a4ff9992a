"""Tmall-specific per-column preprocess hooks (port of
rat_tpu.features.datasets.tmall).

Data-format contract from FuxiCTR (fuxictr/datasets/tmall.py:25-36,
(C) Huawei Technologies, Apache-2.0): ``time_stamp`` is "MDD"/"MMDD" in
the year 2014; derived columns are the weekday number (strftime %w) and
a weekend indicator.
"""

from datetime import date

import numpy as np

from ..feature_encoder import FeatureEncoder as BaseFeatureEncoder


def _weekday_2014(mmdd):
    """'%w' weekday ('0'=Sunday) of a 2014 month/day stamp."""
    return date(2014, int(mmdd[:-2]), int(mmdd[-2:])).strftime("%w")


class FeatureEncoder(BaseFeatureEncoder):
    def convert_weekday(self, df, col_name):
        return np.array([_weekday_2014(ts) for ts in df["time_stamp"].tolist()],
                        dtype=object)

    def convert_weekend(self, df, col_name):
        return np.array(["1" if _weekday_2014(ts) in ("6", "0") else "0"
                         for ts in df["time_stamp"].tolist()], dtype=object)
