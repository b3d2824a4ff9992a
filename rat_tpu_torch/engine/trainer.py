"""Eval runtime (port of the eval half of rat_tpu.engine.trainer).

Each split's token, label and neighbor arrays are uploaded to the
device once (``device_split``); a step receives only a [B] vector of
row ids and gathers the (1+K) x (F+1) grid there (``_gather_batch``).
The final partial batch is padded by repeating row 0 and cut by its
valid count. Predictions stay on the device until the whole split is
scored, then come back in one copy.

Not ported yet: ``fit``, the optimizer, early stopping and the LR
plateau (ROADMAP.md, Queue 1 item 1).
"""

import logging
import os

import numpy as np
import torch

from ..metrics import evaluate_metrics
from ..models import build_model, rat_m2_fast_forward
from ..utils import resolve_device


def _gather_batch(data, idx):
    """Assemble the [B, 1+K, L] grid from device-resident split arrays.
    Returns (X tokens, y labels, nbr_mask or None — the [B, 1+K] mask of
    the corrected ``neighbor_padding="mask"`` mode)."""
    Xt = data["tokens"][idx]
    yt = data["labels"][idx]
    if "nbr" not in data:
        return Xt[:, None, :], yt[:, None], None
    nb = data["nbr"][idx]                                   # [B, K]
    nmask = None
    if "nbr_ok" in data:
        ok = data["nbr_ok"][idx]
        nmask = torch.cat([torch.ones_like(ok[:, :1]), ok], dim=1)
    X = torch.cat([Xt[:, None, :], data["pool_tokens"][nb]], dim=1)
    y = torch.cat([yt[:, None], data["pool_labels"][nb]], dim=1)
    return X, y, nmask


class Trainer(object):
    def __init__(self, feature_map, params, device=None):
        self.device = resolve_device(device)
        self.feature_map = feature_map
        self.params = params
        if params.get("neighbor_padding", "wrap") not in ("wrap", "mask"):
            raise ValueError(
                "neighbor_padding={!r} is not supported (use 'wrap' for "
                "reference bug-parity or 'mask' for corrected "
                "semantics)".format(params["neighbor_padding"]))
        self.model = build_model(feature_map, params).to(self.device).eval()
        self.model_id = params.get("model_id", params["model"])
        self.model_dir = os.path.join(params.get("model_root") or "./exps/",
                                      feature_map.dataset_id)
        self.checkpoint = os.path.abspath(
            os.path.join(self.model_dir, self.model_id + ".model"))
        self._validation_metrics = params.get("metrics", ["AUC", "logloss"])
        self._pool_device_cache = None

    def _use_fast_forward(self):
        """Fused kernel path: ``use_pallas``, the default variant, relu DNN
        and parity (wrap) neighbor padding. (The JAX gate also needs no
        dropout and no BN, which the port's model does not take yet.)"""
        m = self.model
        return (bool(self.params.get("use_pallas", False))
                and m.variant == "default"
                and str(m.dnn_activations).lower() == "relu"
                and self.params.get("neighbor_padding", "wrap") == "wrap")

    def device_split(self, gen):
        """Upload a split. Splits that read the same explicit pool file
        share ONE pool upload; "self" pools key by array identity."""
        def up(arr, dtype):
            return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(self.device)

        darray = gen.darray
        data = {"tokens": up(darray[:, :-1], np.int64),
                "labels": up(darray[:, -1], np.float32)}
        if gen.retrieval_augmented:
            if gen.retr_lens.ndim != 1:
                raise ValueError(
                    "RIM does not support label-wise retrieval-enhanced training")
            pool = gen.pool_darray
            pool_key = getattr(gen, "retrieval_pool_fname", None)
            if pool_key in (None, "self"):
                pool_key = id(pool)
            cached = self._pool_device_cache
            if cached is not None and cached[0] == pool_key:
                data.update(cached[1])
            else:
                pool_up = {"pool_tokens": up(pool[:, :-1], np.int64),
                           "pool_labels": up(pool[:, -1], np.float32)}
                self._pool_device_cache = (pool_key, pool_up)
                data.update(pool_up)
            data["nbr"] = up(gen.neighbor_gather_indices(), np.int64)
            if self.params.get("neighbor_padding", "wrap") == "mask":
                data["nbr_ok"] = up(gen.neighbor_valid_mask(), np.float32)
        return data

    @torch.no_grad()
    def _eval_collect(self, data_gen, data=None):
        """Score every batch; returns host (y_pred, y_true) float32."""
        if data is None:
            data = self.device_split(data_gen)
        use_fast = self._use_fast_forward()
        preds, trues = [], []
        for idx, valid in data_gen.epoch_index_batches():
            idx = torch.from_numpy(idx).to(self.device)
            X, y, nmask = _gather_batch(data, idx)
            if use_fast:
                out = rat_m2_fast_forward(self.model, X, y)
            else:
                out = self.model(X, y, nbr_mask=nmask)
            preds.append(out["y_pred"][:valid, 0])
            trues.append(out["y_true"][:valid, 0])
        return torch.cat(preds).cpu().numpy(), torch.cat(trues).cpu().numpy()

    def evaluate(self, data_gen, data=None):
        y_pred, y_true = self._eval_collect(data_gen, data)
        return evaluate_metrics(y_true.astype(np.float64),
                                y_pred.astype(np.float64),
                                self._validation_metrics)

    def predict(self, data_gen, data=None):
        y_pred, _ = self._eval_collect(data_gen, data)
        return y_pred.astype(np.float64)

    def save_weights(self, checkpoint):
        os.makedirs(os.path.dirname(checkpoint), exist_ok=True)
        torch.save(self.model.state_dict(), checkpoint)

    def load_weights(self, checkpoint):
        state = torch.load(checkpoint, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)
        logging.info("Loaded weights from %s", checkpoint)
