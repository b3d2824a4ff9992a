"""Training and eval runtime (port of rat_tpu.engine.trainer, single
device). Control flow as in the JAX package and the reference
(fuxictr base_model.py:74-230):

- loss = BCE (log terms clamped at -100) over the batch, plus the
  p-norm regularizers split embedding-vs-net by parameter name;
- per step: loss -> backward -> global-norm clip at 10 -> Adam
  (engine/optim.py);
- eval cadence ``every_x_epochs`` (a float is fine) via
  ``on_batch_end``;
- checkpoint / early stop / LR plateau on the monitored metric, with
  min_delta 1e-6, save-best-only, patience counted in EVALUATIONS
  scaled by every_x_epochs, and ``lr *= 0.1`` floored at 1e-6.

Each split's token, label and neighbor arrays are uploaded to the
device once (``device_split``); a step receives only a [B] vector of
row ids and gathers the (1+K) x (F+1) grid there (``_gather_batch``).
A split of several blocks (data/block_loader.py::DataBlockGenerator)
streams instead, in training and evaluation alike: one block view is
uploaded, its batches run, and its buffers are released before the
next is uploaded. ``lazy_valid_upload`` uploads the valid split for
each evaluation and frees it after. ``peak_split_bytes`` counts the
bytes of uploaded split arrays alive at once.
The final partial batch is padded by repeating row 0: training masks
the padded rows out of the loss and divides by the valid count (they
still enter BatchNorm's batch statistics, as in the JAX package), and
scoring cuts them off. Train steps run in ``train()`` mode (dropout,
BatchNorm's batch statistics and running updates), evaluation in
``eval()`` mode on the running statistics; the checkpoint is the state
dict, buffers included. Batch order comes from the Trainer's own
``np.random.RandomState(seed)``, as in the JAX package, so both see the
same batches. Step losses and predictions stay on the device until the
epoch or the split is done, then come back in one copy.

The JAX package's grouped ``lax.scan`` train dispatch is a way to cut
JAX dispatch cost; here a plain loop takes its place. The full train
state (``save_train_state``/``restore_train_state``, engine/checkpoint.py)
resumes a run exactly. ``profile_dir`` writes a torch.profiler trace of
steps 2 to 2 + ``profile_steps`` of the first epoch. Not ported yet:
the mesh.
"""

import logging
import os
import time
import weakref

import numpy as np
import torch

from ..data.block_loader import DataBlockGenerator
from ..metrics import evaluate_metrics
from ..models import build_model, rat_m2_fast_forward
from ..nn.layers import set_dropout_generator
from ..utils import Monitor, resolve_device
from .optim import (get_learning_rate, get_optimizer, regularization_loss,
                    set_learning_rate)


def _bce(pred, target):
    """torch F.binary_cross_entropy parity: log terms clamped at -100."""
    logp = torch.clamp(torch.log(pred), min=-100.0)
    log1mp = torch.clamp(torch.log(1.0 - pred), min=-100.0)
    return -(target * logp + (1.0 - target) * log1mp)


def get_loss_fn(loss):
    """Elementwise loss by config name (torch_utils.py:51-63 semantics)."""
    if isinstance(loss, str):
        name = loss.lower()
        if name in ("bce", "binary_crossentropy", "binary_cross_entropy"):
            return _bce
        if name in ("mse", "mse_loss", "mean_squared_error"):
            return lambda pred, target: (pred - target) ** 2
        if name in ("mae", "l1_loss"):
            return lambda pred, target: torch.abs(pred - target)
        raise NotImplementedError("loss={} is not supported.".format(loss))
    return loss  # callable


def _gather_batch(data, idx):
    """Assemble the [B, 1+K, L] grid from device-resident split arrays.
    Returns (X tokens, y labels, X_num — the float values of the same
    columns, or None without numeric fields —, nbr_mask or None — the
    [B, 1+K] mask of the corrected ``neighbor_padding="mask"`` mode)."""
    Xt = data["tokens"][idx]
    yt = data["labels"][idx]
    Xf = data["numeric"][idx] if "numeric" in data else None
    if "nbr" not in data:
        return Xt[:, None, :], yt[:, None], None if Xf is None else Xf[:, None, :], None
    nb = data["nbr"][idx]                                   # [B, K]
    nmask = None
    if "nbr_ok" in data:
        ok = data["nbr_ok"][idx]
        nmask = torch.cat([torch.ones_like(ok[:, :1]), ok], dim=1)
    X = torch.cat([Xt[:, None, :], data["pool_tokens"][nb]], dim=1)
    y = torch.cat([yt[:, None], data["pool_labels"][nb]], dim=1)
    if Xf is not None:
        Xf = torch.cat([Xf[:, None, :], data["pool_numeric"][nb]], dim=1)
    return X, y, Xf, nmask


class _ResidentBytes(object):
    """Bytes of the uploaded split tensors that are still alive, and the
    most alive at once."""

    def __init__(self):
        self.now = self.peak = 0

    def add(self, tensor):
        n = tensor.numel() * tensor.element_size()
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(tensor, self._sub, n)

    def _sub(self, n):
        self.now -= n


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
        # dropout masks come from the Trainer's own generator on the
        # device, so a run is reproducible without the global RNG
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            int(params.get("seed", 2021)))
        set_dropout_generator(self.model, self.dropout_generator)
        self._has_numeric = any(spec["type"] == "numeric"
                                for spec in feature_map.feature_specs.values())
        self.model_id = params.get("model_id", params["model"])
        self.model_dir = os.path.join(params.get("model_root") or "./exps/",
                                      feature_map.dataset_id)
        self.checkpoint = os.path.abspath(
            os.path.join(self.model_dir, self.model_id + ".model"))
        self._validation_metrics = params.get("metrics", ["AUC", "logloss"])
        self._pool_device_cache = None
        self._block_mode = False
        self._resident = _ResidentBytes()
        self._profile_dir = params.get("profile_dir", None)
        self._profile_steps = params.get("profile_steps", 10)
        self._monitor = Monitor(kv=params.get("monitor", "AUC"))
        self._monitor_mode = params.get("monitor_mode", "max")
        self._patience = params.get("patience", 2)
        self._every_x_epochs = params.get("every_x_epochs", 1)
        self._save_best_only = params.get("save_best_only", True)
        self._embedding_regularizer = params.get("embedding_regularizer", None)
        self._net_regularizer = params.get("net_regularizer", None)
        self._reduce_lr_on_plateau = params.get("reduce_lr_on_plateau", True)
        self._loss_fn = get_loss_fn(params.get("loss", "binary_crossentropy"))
        # dedicated host RNG for batch shuffling, as in the JAX package:
        # batch order must not depend on code touching np.random
        self._shuffle_rng = np.random.RandomState(params.get("seed", 2021))
        self._optimizer = None
        self._resumed = None
        #: every train step's loss, in order, filled at each epoch's end
        self.step_losses = []
        #: each epoch's seconds, its evaluations included
        self.epoch_seconds = []

    @property
    def peak_split_bytes(self):
        """The most bytes of uploaded split arrays alive at one time."""
        return self._resident.peak

    @property
    def optimizer(self):
        """Adam behind the global-norm clip, built at first use, so that
        a Trainer that only scores never builds it: the first torch
        optimizer of a process imports torch._dynamo, which takes
        seconds."""
        if self._optimizer is None:
            p = self.params
            self._optimizer = get_optimizer(p.get("optimizer", "adam"),
                                            self.model.parameters(),
                                            p.get("learning_rate", 1e-3),
                                            p.get("max_gradient_norm", 10.))
        return self._optimizer

    def _use_fast_forward(self):
        """The JAX package's gate of its fused path: ``use_pallas``, the
        default variant, no dropout of any kind, no BatchNorm, relu DNN
        and parity (wrap) neighbor padding. With the gate false the
        module path runs, kernel K1 never."""
        m = self.model
        return (bool(self.params.get("use_pallas", False))
                and m.variant == "default"
                and m.dropout == 0 and m.emb_dropout == 0
                and m.net_dropout == 0 and not m.batch_norm
                and str(m.dnn_activations).lower() == "relu"
                and self.params.get("neighbor_padding", "wrap") == "wrap")

    def device_split(self, gen, share_pool=True):
        """Upload a split. With ``share_pool``, splits that read the same
        explicit pool file share ONE pool upload, and other pools key by
        the array's ``id()``; the cache holds the array, so that its
        address cannot pass to a later array while the key lives. Block
        streams pass False: their pools go with their block."""
        def up(arr, dtype):
            t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(self.device)
            self._resident.add(t)
            return t

        darray = gen.darray
        data = {"tokens": up(darray[:, :-1], np.int64),
                "labels": up(darray[:, -1], np.float32)}
        if self._has_numeric:
            data["numeric"] = up(darray[:, :-1], np.float32)
        if gen.retrieval_augmented:
            if gen.retr_lens.ndim != 1:
                raise ValueError(
                    "RIM does not support label-wise retrieval-enhanced training")
            pool = gen.pool_darray
            pool_key = getattr(gen, "retrieval_pool_fname", None)
            if pool_key in (None, "self"):
                pool_key = id(pool)
            cached = self._pool_device_cache if share_pool else None
            if cached is not None and cached[0] == pool_key:
                data.update(cached[1])
            else:
                pool_up = {"pool_tokens": up(pool[:, :-1], np.int64),
                           "pool_labels": up(pool[:, -1], np.float32)}
                if self._has_numeric:
                    pool_up["pool_numeric"] = up(pool[:, :-1], np.float32)
                if share_pool:
                    self._pool_device_cache = (pool_key, pool_up, pool)
                data.update(pool_up)
            data["nbr"] = up(gen.neighbor_gather_indices(), np.int64)
            if self.params.get("neighbor_padding", "wrap") == "mask":
                data["nbr_ok"] = up(gen.neighbor_valid_mask(), np.float32)
        return data

    def _forward(self, data, idx):
        """Gather one batch and run the fused or the module forward."""
        X, y, Xf, nmask = _gather_batch(data, idx)
        if self._use_fast_forward():
            return rat_m2_fast_forward(self.model, X, y, Xf)
        return self.model(X, y, Xf, nbr_mask=nmask)

    # ---- training ---------------------------------------------------------
    def loss_and_grads(self, data, idx, valid):
        """Forward and backward of one batch in training mode (idx: [B]
        device row ids, the first ``valid`` real). The padded rows enter
        BatchNorm's batch statistics, as in the JAX package, but not the
        loss. The gradients of the total loss, regularizer included, are
        left in each parameter's ``.grad``. Returns the loss as a device
        scalar."""
        self.model.train()
        out = self._forward(data, idx)
        pred = out["y_pred"][:, 0]
        target = out["y_true"][:, 0]
        mask = (torch.arange(pred.shape[0], device=pred.device) < valid).to(pred.dtype)
        loss = torch.sum(self._loss_fn(pred, target) * mask) / valid
        loss = loss + regularization_loss(self.model.named_parameters(),
                                          self._embedding_regularizer,
                                          self._net_regularizer)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    def train_step(self, data, idx, valid):
        """One step: loss, gradients, clip, Adam. Returns the loss."""
        loss = self.loss_and_grads(data, idx, valid)
        self.optimizer.step()
        return loss

    def _block_stream(self, views, rng=None):
        """(device data, row ids, valid count) for every batch of every
        block view, one block on the device at a time: a view is
        uploaded when its first batch is asked for, and the last batch
        hands the caller the only reference to its buffers, so that the
        block is freed when the caller drops it, before the next upload.
        Row orders are drawn from ``rng`` block by block, after each
        block is loaded, as in the JAX package."""
        for view in views:
            box = [self.device_split(view, share_pool=False)]
            batches = list(view.epoch_index_batches(rng=rng))
            for i, (idx, valid) in enumerate(batches):
                yield (box.pop() if i == len(batches) - 1 else box[0]), idx, valid

    def _epoch_stream(self, train_gen):
        if self._block_mode:
            return self._block_stream(
                train_gen.iter_block_views(rng=self._shuffle_rng), self._shuffle_rng)
        if self._train_data is None:
            self._train_data = self.device_split(train_gen)
        return ((self._train_data, idx, valid) for idx, valid in
                train_gen.epoch_index_batches(rng=self._shuffle_rng))

    def _eval_stream(self, data_gen, data=None):
        if isinstance(data_gen, DataBlockGenerator):
            return self._block_stream(data_gen.iter_block_views())
        if data is None:
            data = self.device_split(data_gen)
        return ((data, idx, valid) for idx, valid in data_gen.epoch_index_batches())

    def fit(self, train_gen, validation_data=None, epochs=1):
        """Train for ``epochs``. A DataBlockGenerator train split streams
        block by block; a DataBlockGenerator valid split, or any valid
        split under ``lazy_valid_upload``, is uploaded per evaluation."""
        self.valid_gen = validation_data
        self._block_mode = isinstance(train_gen, DataBlockGenerator)
        lazy_valid = bool(self.params.get("lazy_valid_upload", False))
        self._valid_data = None if (lazy_valid or isinstance(
            validation_data, DataBlockGenerator)) else self.device_split(validation_data)
        self._train_data = None if self._block_mode else self.device_split(train_gen)
        # a restored train state carries the monitor's bookkeeping on
        resumed, self._resumed = self._resumed or {}, None
        self._best_metric = resumed.get(
            "best_metric", np.inf if self._monitor_mode == "min" else -np.inf)
        self._stopping_steps = resumed.get("stopping_steps", 0)
        self._total_batches = resumed.get("total_batches", 0)
        self._batches_per_epoch = len(train_gen)
        self._every_x_batches = int(np.ceil(self._every_x_epochs *
                                            self._batches_per_epoch))
        self._stop_training = False
        self.step_losses = []
        self.epoch_seconds = []
        logging.info("Start training: {} batches/epoch".format(
            self._batches_per_epoch))
        for epoch in range(epochs):
            logging.info("************ Epoch={} start ************".format(epoch + 1))
            epoch_loss, examples, secs = self.train_one_epoch(train_gen, epoch)
            self.epoch_seconds.append(secs)
            logging.info("Train loss: {:.6f}".format(epoch_loss))
            logging.info("Train throughput: {:.0f} examples/s".format(
                examples / max(secs, 1e-9)))
            if self._stop_training:
                break
            logging.info("************ Epoch={} end ************".format(epoch + 1))
        self.model.eval()
        logging.info("Training finished.")

    def train_one_epoch(self, train_gen, epoch):
        """Returns (epoch loss, examples, seconds). The epoch loss divides
        by the FULL batch count even when early stop cuts the epoch
        short (the reference's denominator, base_model.py:226-228). With
        ``profile_dir``, steps 2 to 2 + ``profile_steps`` of the first
        epoch are traced."""
        losses = []
        examples = 0
        tic = time.time()
        self.model.train()
        profiler = None
        batch_index = 0
        # no enumerate(): its cached result tuple would keep the last
        # block's buffers alive into the evaluation
        for data, idx, valid in self._epoch_stream(train_gen):
            if self._profile_dir is not None and epoch == 0 and batch_index == 2:
                profiler = self._start_profile()
            idx = torch.from_numpy(idx).to(self.device)
            losses.append(self.train_step(data, idx, valid))
            del data
            examples += valid
            if profiler is not None and batch_index == 2 + self._profile_steps:
                profiler = self._stop_profile(profiler)
            self.on_batch_end(batch_index)
            batch_index += 1
            if self._stop_training:
                break
        if profiler is not None:
            self._stop_profile(profiler)
        step_losses = torch.stack(losses).cpu().numpy()
        self.step_losses.extend(step_losses.tolist())
        epoch_secs = time.time() - tic
        # a float32 running sum, as the JAX package's
        return float(sum(step_losses)) / self._batches_per_epoch, examples, epoch_secs

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler):
        """Stop the trace and write it to ``profile_dir``; returns None."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, "trace_{}.json".format(os.getpid()))
        profiler.export_chrome_trace(path)
        logging.info("Profiler trace written to {}".format(path))
        return None

    def on_batch_end(self, batch):
        self._total_batches += 1
        if (batch + 1) % self._every_x_batches == 0 or \
                (batch + 1) % self._batches_per_epoch == 0:
            epoch = round(float(self._total_batches) / self._batches_per_epoch, 2)
            val_logs = self.evaluate(self.valid_gen, data=self._valid_data)
            self.checkpoint_and_earlystop(epoch, val_logs)
            logging.info("--- {}/{} batches finished ---".format(
                batch + 1, self._batches_per_epoch))

    def lr_decay(self, factor=0.1, min_lr=1e-6):
        reduced_lr = max(get_learning_rate(self.optimizer) * factor, min_lr)
        set_learning_rate(self.optimizer, reduced_lr)
        return reduced_lr

    def checkpoint_and_earlystop(self, epoch, logs, min_delta=1e-6):
        monitor_value = self._monitor.get_value(logs)
        if (self._monitor_mode == "min" and
                monitor_value > self._best_metric - min_delta) or \
           (self._monitor_mode == "max" and
                monitor_value < self._best_metric + min_delta):
            self._stopping_steps += 1
            logging.info("Monitor({}) STOP: {:.6f} !".format(
                self._monitor_mode, monitor_value))
            if self._reduce_lr_on_plateau:
                current_lr = self.lr_decay()
                logging.info("Reduce learning rate on plateau: {:.6f}"
                             .format(current_lr))
        else:
            self._stopping_steps = 0
            self._best_metric = monitor_value
            if self._save_best_only:
                logging.info("Save best model: monitor({}): {:.6f}"
                             .format(self._monitor_mode, monitor_value))
                self.save_weights(self.checkpoint)
        if self._stopping_steps * self._every_x_epochs >= self._patience:
            self._stop_training = True
            logging.info("Early stopping at epoch={:g}".format(epoch))
        if not self._save_best_only:
            self.save_weights(self.checkpoint)

    # ---- evaluation -------------------------------------------------------
    @torch.no_grad()
    def _eval_collect(self, data_gen, data=None):
        """Score every batch in eval mode (a DataBlockGenerator block by
        block); returns host (y_pred, y_true) float32."""
        training = self.model.training
        self.model.eval()
        preds, trues = [], []
        for split_data, idx, valid in self._eval_stream(data_gen, data):
            out = self._forward(split_data, torch.from_numpy(idx).to(self.device))
            del split_data
            preds.append(out["y_pred"][:valid, 0])
            trues.append(out["y_true"][:valid, 0])
        self.model.train(training)
        return torch.cat(preds).cpu().numpy(), torch.cat(trues).cpu().numpy()

    def evaluate(self, data_gen, data=None):
        y_pred, y_true = self._eval_collect(data_gen, data)
        return evaluate_metrics(y_true.astype(np.float64),
                                y_pred.astype(np.float64),
                                self._validation_metrics)

    def predict(self, data_gen, data=None):
        y_pred, _ = self._eval_collect(data_gen, data)
        return y_pred.astype(np.float64)

    def count_parameters(self, count_embedding=True):
        total = sum(p.numel() for name, p in self.model.named_parameters()
                    if count_embedding or "embedding" not in name)
        logging.info("Total number of parameters: {}.".format(total))
        return total

    # ---- full-state checkpoint/resume ---------------------------------------
    def save_train_state(self, path):
        """Checkpoint the full train state (weights and buffers, Adam's
        moments, step and learning rate) plus the monitor's bookkeeping
        and the host and dropout RNG states, for an exact resume."""
        from .checkpoint import save_train_state
        mode, bits, pos, has_gauss, gauss = self._shuffle_rng.get_state()
        extra = {
            "best_metric": float(getattr(self, "_best_metric", -np.inf)),
            "stopping_steps": int(getattr(self, "_stopping_steps", 0)),
            "total_batches": int(getattr(self, "_total_batches", 0)),
            "shuffle_rng": [mode, bits.tolist(), int(pos), int(has_gauss), float(gauss)],
            "dropout_rng": self.dropout_generator.get_state().tolist(),
        }
        save_train_state(path, self.model.state_dict(), self.optimizer.state_dict(),
                         extra)

    def restore_train_state(self, path):
        """Load a state saved by :meth:`save_train_state`; the next
        ``fit`` continues its bookkeeping instead of starting afresh."""
        from .checkpoint import restore_train_state
        state, extra = restore_train_state(path, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if extra:
            mode, bits, pos, has_gauss, gauss = extra["shuffle_rng"]
            self._shuffle_rng.set_state((mode, np.asarray(bits, dtype=np.uint32),
                                         pos, has_gauss, gauss))
            self.dropout_generator.set_state(
                torch.tensor(extra["dropout_rng"], dtype=torch.uint8))
            self._resumed = {k: extra[k] for k in
                             ("best_metric", "stopping_steps", "total_batches")}
        return extra

    def save_weights(self, checkpoint):
        os.makedirs(os.path.dirname(checkpoint), exist_ok=True)
        torch.save(self.model.state_dict(), checkpoint)

    def load_weights(self, checkpoint):
        state = torch.load(checkpoint, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)
        logging.info("Loaded weights from %s", checkpoint)
