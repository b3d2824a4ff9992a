"""Evaluation metrics (port of rat_tpu.metrics), computed on the host
in float64 over the full prediction vector.

- logloss: predictions clipped to [1e-7, 1 - 1e-7] (sklearn log_loss
  eps=1e-7 semantics);
- AUC: the Mann-Whitney statistic over tie-averaged ranks, which is
  exactly sklearn's ``roc_auc_score`` without needing sklearn.
"""

import logging

import numpy as np
from scipy.stats import rankdata


def logloss(y_true, y_pred, eps=1e-7):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.clip(np.asarray(y_pred, dtype=np.float64), eps, 1 - eps)
    return float(-np.mean(y_true * np.log(y_pred) + (1 - y_true) * np.log(1 - y_pred)))


def AUC(y_true, y_pred):
    """Probability that a random positive outranks a random negative,
    ties counting one half."""
    y_true = np.asarray(y_true, dtype=np.float64)
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    ranks = rankdata(np.asarray(y_pred, dtype=np.float64))
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def evaluate_metrics(y_true, y_pred, metrics, **kwargs):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    result = dict()
    for metric in metrics:
        if metric in ["logloss", "binary_crossentropy"]:
            result[metric] = logloss(y_true, y_pred)
        elif metric == "AUC":
            result[metric] = AUC(y_true, y_pred)
        else:
            raise NotImplementedError("metric={} is not supported.".format(metric))
    logging.info("[Metrics] " + " - ".join(
        "{}: {:.6f}".format(k, v) for k, v in result.items()))
    return result
