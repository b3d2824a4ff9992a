"""KKBox-specific per-column preprocess hooks (port of
rat_tpu.features.datasets.kkbox).

Data-format contract from FuxiCTR (fuxictr/datasets/kkbox.py:24-50,
(C) Huawei Technologies, Apache-2.0): the ISRC's first two characters
are the registrant country, and listener ages bucket into decades with
1..95 as the plausible range.
"""

import numpy as np

from ..csv_table import is_missing
from ..feature_encoder import FeatureEncoder as BaseFeatureEncoder

# decade buckets over the valid age range; ages outside [1, 95] and
# missing values map to "" (treated as NA by the tokenizer)
_AGE_EDGES = [10, 20, 30, 40, 50, 60]


def _coerce_float(value):
    """``pd.to_numeric(errors="coerce")`` of one cell."""
    if value is None:
        return np.nan
    try:
        return float(value) if "_" not in str(value) else np.nan
    except ValueError:
        return np.nan


class FeatureEncoder(BaseFeatureEncoder):
    def extract_country_code(self, df, col_name):
        # ISRC prefix (2-char registrant country)
        values = df[col_name]
        missing = is_missing(values)
        return np.array(["" if m else str(v)[:2] for v, m in zip(values.tolist(), missing)],
                        dtype=object)

    def bucketize_age(self, df, col_name):
        ages = np.array([_coerce_float(v) for v in df[col_name].tolist()],
                        dtype=np.float64)
        with np.errstate(invalid="ignore"):
            bucket = 1 + np.searchsorted(_AGE_EDGES, np.nan_to_num(ages))
            valid = ~np.isnan(ages) & (ages >= 1) & (ages <= 95)
        return np.where(valid, bucket.astype(str), "").astype(object)
