"""Evaluation metrics (port of rat_tpu.metrics), computed on the host
in float64 over the full prediction vector.

- logloss: predictions clipped to [1e-7, 1 - 1e-7] (sklearn log_loss
  eps=1e-7 semantics);
- AUC: the Mann-Whitney statistic over tie-averaged ranks, which is
  exactly sklearn's ``roc_auc_score`` without needing sklearn;
- GAUC, NDCG, MRR and HitRate over the groups of ``group_index``, as the
  JAX package computes them (GAUC on this module's AUC).
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


def _group_slices(group_index):
    order = np.argsort(group_index, kind="mergesort")
    sorted_groups = np.asarray(group_index)[order]
    boundaries = np.flatnonzero(np.diff(sorted_groups)) + 1
    return order, np.split(order, boundaries)


def GAUC(y_true, y_pred, group_index):
    """Impression-weighted mean of the per-group AUCs; groups of one
    class are skipped."""
    _, groups = _group_slices(group_index)
    total_w = 0.0
    total = 0.0
    for g in groups:
        yt = y_true[g]
        if yt.min() == yt.max():
            continue
        total += len(g) * AUC(yt, y_pred[g])
        total_w += len(g)
    return float(total / total_w) if total_w else 0.0


def NDCG(y_true, y_pred, group_index, k=10):
    _, groups = _group_slices(group_index)
    scores = []
    for g in groups:
        yt, yp = y_true[g], y_pred[g]
        order = np.argsort(-yp, kind="stable")[:k]
        gains = (2 ** yt[order] - 1) / np.log2(np.arange(2, len(order) + 2))
        ideal_order = np.argsort(-yt, kind="stable")[:k]
        ideal = (2 ** yt[ideal_order] - 1) / np.log2(np.arange(2, len(ideal_order) + 2))
        denom = ideal.sum()
        scores.append(gains.sum() / denom if denom > 0 else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def MRR(y_true, y_pred, group_index):
    _, groups = _group_slices(group_index)
    scores = []
    for g in groups:
        yt, yp = y_true[g], y_pred[g]
        order = np.argsort(-yp, kind="stable")
        hits = np.flatnonzero(yt[order] > 0)
        scores.append(1.0 / (hits[0] + 1) if len(hits) else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def HitRate(y_true, y_pred, group_index, k=10):
    _, groups = _group_slices(group_index)
    scores = []
    for g in groups:
        yt, yp = y_true[g], y_pred[g]
        order = np.argsort(-yp, kind="stable")[:k]
        scores.append(1.0 if (yt[order] > 0).any() else 0.0)
    return float(np.mean(scores)) if scores else 0.0


_GROUPED = {"GAUC": GAUC, "NDCG": NDCG, "MRR": MRR, "HitRate": HitRate}


def evaluate_metrics(y_true, y_pred, metrics, **kwargs):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    result = dict()
    for metric in metrics:
        if metric in ["logloss", "binary_crossentropy"]:
            result[metric] = logloss(y_true, y_pred)
        elif metric == "AUC":
            result[metric] = AUC(y_true, y_pred)
        elif metric in _GROUPED:
            if "group_index" not in kwargs:
                raise ValueError("group_index is required for {}".format(metric))
            result[metric] = _GROUPED[metric](y_true, y_pred, kwargs["group_index"])
        else:
            raise NotImplementedError("metric={} is not supported.".format(metric))
    logging.info("[Metrics] " + " - ".join(
        "{}: {:.6f}".format(k, v) for k, v in result.items()))
    return result
