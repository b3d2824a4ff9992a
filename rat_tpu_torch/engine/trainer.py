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
steps 2 to 2 + ``profile_steps`` of the first epoch. ``dedup_neighbors``
(or RAT_TPU_DEDUP_NEIGHBORS=1) gathers each batch's pool rows once per
distinct row and expands them with the inverse index: the same grid.

Under a mesh (``mesh``, parallel/mesh.py), one process per device:

- every rank draws the full initial weights from the same generator and
  keeps its rows of the row-sharded tables (``embedding_layer.table``
  and the wide tower's), so a mesh run starts from one device's
  weights; lookups sum the ranks' partial rows over the model group
  (nn/embedding.py). A model axis of 1 keeps the tables whole and
  looks them up locally;
- every rank uploads whole splits and walks the same global batches,
  running its contiguous slice of each; its loss is its masked sum over
  the GLOBAL valid count, and the regularizer is added on data rank 0
  only (the other data ranks add it times 0, so that every rank's
  gradients cover the same parameters);
- after backward, all gradients are summed over the data group (the loss
  is already divided globally: a mean would be wrong), and the
  global-norm clip sums the sharded tables' squared norms over the model
  group;
- BatchNorm takes the global batch's statistics over the data group,
  and dropout draws the global batch's mask and keeps its rows, so a
  step equals one device's step; kernel K1 runs on the local slice when
  its gate holds (BatchNorm closes it, so K1 never reduces across
  ranks);
- evaluation all-gathers the predictions over the data group in row
  order, and every rank computes the same metrics;
- ``save_weights`` and ``save_train_state`` gather the tables' rows and
  their optimizer moments and rank 0 writes what one device writes;
  ``load_weights`` and ``restore_train_state`` read on rank 0, broadcast,
  and every rank keeps its rows. The reported step loss is the global
  one, on every rank.
"""

import logging
import os
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..data.block_loader import DataBlockGenerator
from ..metrics import evaluate_metrics
from ..models import build_model, rat_m2_fast_forward
from ..nn.embedding import PackedEmbedding
from ..nn.layers import set_batch_norm_group, set_dropout_generator
from ..parallel import (from_rank0, is_row_sharded, on_rank0, process_local_rows,
                        shard_range)
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


def _gather_batch(data, idx, dedup_neighbors=False):
    """Assemble the [B, 1+K, L] grid from device-resident split arrays.
    Returns (X tokens, y labels, X_num — the float values of the same
    columns, or None without numeric fields —, nbr_mask or None — the
    [B, 1+K] mask of the corrected ``neighbor_padding="mask"`` mode).
    ``dedup_neighbors`` gathers each distinct pool row once and expands
    with the inverse index (``torch.unique``): identical outputs."""
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
    if dedup_neighbors:
        uniq, inverse = torch.unique(nb, return_inverse=True)

        def pool_rows(pool):
            return pool[uniq][inverse]
    else:
        def pool_rows(pool):
            return pool[nb]
    X = torch.cat([Xt[:, None, :], pool_rows(data["pool_tokens"])], dim=1)
    y = torch.cat([yt[:, None], pool_rows(data["pool_labels"])], dim=1)
    if Xf is not None:
        Xf = torch.cat([Xf[:, None, :], pool_rows(data["pool_numeric"])], dim=1)
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
    def __init__(self, feature_map, params, device=None, mesh=None):
        """``device``: None means CUDA; ``mesh``: this process's place in a
        (data, model) mesh (parallel/mesh.py), whose device it runs on."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError("device {} is not the mesh's {}".format(
                    device, mesh.device))
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.feature_map = feature_map
        self.params = params
        if params.get("neighbor_padding", "wrap") not in ("wrap", "mask"):
            raise ValueError(
                "neighbor_padding={!r} is not supported (use 'wrap' for "
                "reference bug-parity or 'mask' for corrected "
                "semantics)".format(params["neighbor_padding"]))
        model = build_model(feature_map, params)
        #: row-sharded parameter name -> (full rows, first local row); a
        #: model axis of 1 keeps every table whole and looks it up locally
        self._sharded = {}
        if mesh is not None:
            for name, module in model.named_modules():
                if mesh.model > 1 and isinstance(module, PackedEmbedding) and \
                        is_row_sharded(name + ".table", module.table):
                    rows = module.table.shape[0]
                    lo, hi = shard_range(rows, mesh.model, mesh.model_index)
                    module.shard_rows(lo, hi, mesh.model_group)
                    self._sharded[name + ".table"] = (rows, lo)
            set_batch_norm_group(model, mesh.data_group)
        self.model = model.to(self.device).eval()
        # dropout masks come from the Trainer's own generator on the
        # device, so a run is reproducible without the global RNG
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            int(params.get("seed", 2021)))
        set_dropout_generator(self.model, self.dropout_generator,
                              None if mesh is None else (mesh.data, mesh.data_index))
        self._dedup = bool(params.get("dedup_neighbors", False)) or \
            os.environ.get("RAT_TPU_DEDUP_NEIGHBORS") == "1"
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
            self._optimizer = get_optimizer(
                p.get("optimizer", "adam"), self.model.parameters(),
                p.get("learning_rate", 1e-3), p.get("max_gradient_norm", 10.),
                None if self.mesh is None else self._mesh_grad_sq_norm)
        return self._optimizer

    def _mesh_grad_sq_norm(self, params):
        """The squared norm of the whole gradient under a mesh: the
        sharded tables' squares summed over the model group, the
        replicated parameters' counted once."""
        sharded = {id(p) for n, p in self.model.named_parameters() if n in self._sharded}
        zero = torch.zeros((), device=self.device)
        rows = sum(((p.grad * p.grad).sum() for p in params
                    if p.grad is not None and id(p) in sharded), zero)
        if sharded:
            dist.all_reduce(rows, group=self.mesh.model_group)
        return sum(((p.grad * p.grad).sum() for p in params
                    if p.grad is not None and id(p) not in sharded), zero) + rows

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
        X, y, Xf, nmask = _gather_batch(data, idx, self._dedup)
        if self._use_fast_forward():
            return rat_m2_fast_forward(self.model, X, y, Xf)
        return self.model(X, y, Xf, nbr_mask=nmask)

    # ---- training ---------------------------------------------------------
    def loss_and_grads(self, data, idx, valid):
        """Forward and backward of one batch in training mode (idx: [B]
        device row ids, the first ``valid`` real; under a mesh the GLOBAL
        batch, of which this rank runs its slice). The padded rows enter
        BatchNorm's batch statistics, as in the JAX package, but not the
        loss. The gradients of the total loss, regularizer included, are
        left in each parameter's ``.grad`` (under a mesh, summed over the
        data group). Returns the loss as a device scalar."""
        self.model.train()
        offset = 0
        if self.mesh is not None:
            idx = process_local_rows(idx, self.mesh)
            offset = self.mesh.data_index * len(idx)
        out = self._forward(data, idx)
        pred = out["y_pred"][:, 0]
        target = out["y_true"][:, 0]
        rows = torch.arange(pred.shape[0], device=pred.device) + offset
        mask = (rows < valid).to(pred.dtype)
        loss = torch.sum(self._loss_fn(pred, target) * mask) / valid
        if self.mesh is None:
            loss = loss + regularization_loss(self.model.named_parameters(),
                                              self._embedding_regularizer,
                                              self._net_regularizer)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            return loss.detach()
        return self._mesh_backward(loss)

    def _mesh_backward(self, data_loss):
        """Backward of this rank's loss under the mesh, the gradients
        summed over the data group; returns the global loss."""
        mesh = self.mesh
        named = list(self.model.named_parameters())
        regs = [regularization_loss([(n, p) for n, p in named if
                                     (n in self._sharded) == sharded],
                                    self._embedding_regularizer, self._net_regularizer)
                for sharded in (True, False)]
        reg = regs[0] + regs[1]
        loss = data_loss + (reg if mesh.data_index == 0 else reg * 0.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for _, p in named if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])   # one collective
        dist.all_reduce(flat, group=mesh.data_group)
        for g, summed in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(summed.view_as(g))
        # the global loss: the data terms of one model column, the
        # replicated parameters' regularizer once, each table shard's once
        report = data_loss.detach() * float(mesh.model_index == 0)
        if mesh.rank == 0:
            report = report + regs[1]
        if mesh.data_index == 0:
            report = report + regs[0]
        report = torch.as_tensor(report, device=self.device).detach().clone()
        dist.all_reduce(report)
        return report

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
        preds, trues, valids = [], [], []
        for split_data, idx, valid in self._eval_stream(data_gen, data):
            idx = torch.from_numpy(idx).to(self.device)
            valids.append(valid)
            if self.mesh is not None:
                idx, valid = process_local_rows(idx, self.mesh), None
            out = self._forward(split_data, idx)
            del split_data
            preds.append(out["y_pred"][:valid, 0])
            trues.append(out["y_true"][:valid, 0])
        self.model.train(training)
        if self.mesh is None:
            return torch.cat(preds).cpu().numpy(), torch.cat(trues).cpu().numpy()
        return self._gather_predictions(preds, trues, valids)

    def _gather_predictions(self, preds, trues, valids):
        """Every data rank's [per] slices of each batch, all-gathered in
        row order over the data group and cut to each batch's valid
        rows; the same host arrays on every rank."""
        local = torch.stack([torch.stack(preds), torch.stack(trues)])   # [2, nb, per]
        parts = [torch.empty_like(local) for _ in range(self.mesh.data)]
        dist.all_gather(parts, local, group=self.mesh.data_group)
        full = torch.cat(parts, dim=2).cpu().numpy()                    # [2, nb, B]
        return tuple(np.concatenate([row[b, :v] for b, v in enumerate(valids)])
                     for row in full)

    def evaluate(self, data_gen, data=None):
        y_pred, y_true = self._eval_collect(data_gen, data)
        return evaluate_metrics(y_true.astype(np.float64),
                                y_pred.astype(np.float64),
                                self._validation_metrics)

    def predict(self, data_gen, data=None):
        y_pred, _ = self._eval_collect(data_gen, data)
        return y_pred.astype(np.float64)

    def count_parameters(self, count_embedding=True):
        """The parameters of the whole model (sharded tables at their full
        rows)."""
        total = sum(p.numel() // max(p.shape[0], 1) * self._sharded[name][0]
                    if name in self._sharded else p.numel()
                    for name, p in self.model.named_parameters()
                    if count_embedding or "embedding" not in name)
        logging.info("Total number of parameters: {}.".format(total))
        return total

    # ---- sharded tables <-> one device's state ---------------------------
    def _gather_rows(self, local, rows):
        """A sharded table's (or moment's) full [rows, ...] tensor from the
        model group's parts (each padded to ceil(rows / model))."""
        per = -(-rows // self.mesh.model)
        padded = local.new_zeros((per,) + tuple(local.shape[1:]))
        padded[:len(local)] = local
        parts = [torch.empty_like(padded) for _ in range(self.mesh.model)]
        dist.all_gather(parts, padded, group=self.mesh.model_group)
        return torch.cat(parts)[:rows]

    def _sharded_slots(self):
        """(position in parameters(), name, full rows, first row, local
        shape) of each sharded parameter."""
        return [(i, n, rows, lo, tuple(p.shape))
                for i, (n, p) in enumerate(self.model.named_parameters())
                for rows, lo in [self._sharded.get(n, (None, None))] if rows is not None]

    def model_state(self):
        """The state dict one device holds: under a mesh, the sharded
        tables gathered over the model group (every rank must call it)."""
        state = self.model.state_dict()
        for _, name, rows, _, _ in self._sharded_slots():
            state[name] = self._gather_rows(state[name], rows)
        return state

    def load_model_state(self, state):
        """Load one device's state dict (a checkpoint, or
        convert.params_from_jax's); under a mesh every rank keeps its
        rows of the sharded tables."""
        state = dict(state)
        for _, name, _, lo, shape in self._sharded_slots():
            state[name] = state[name][lo: lo + shape[0]]
        self.model.load_state_dict(state)

    def _optimizer_state(self):
        """The optimizer's state dict as one device holds it: the
        moments of the sharded tables gathered like the tables."""
        state = self.optimizer.state_dict()
        for i, _, rows, _, shape in self._sharded_slots():
            if i not in state["state"]:
                continue
            # state_dict() shares the live per-parameter dicts: copy
            slot = state["state"][i] = dict(state["state"][i])
            for key, value in slot.items():
                if torch.is_tensor(value) and tuple(value.shape) == shape:
                    slot[key] = self._gather_rows(value, rows)
        return state

    def _load_optimizer_state(self, state):
        for i, _, rows, lo, shape in self._sharded_slots():
            slot = state["state"].get(i, {})
            for key, value in slot.items():
                if torch.is_tensor(value) and value.dim() and value.shape[0] == rows \
                        and tuple(value.shape[1:]) == shape[1:]:
                    slot[key] = value[lo: lo + shape[0]]
        self.optimizer.load_state_dict(state)

    # ---- full-state checkpoint/resume ---------------------------------------
    def save_train_state(self, path):
        """Checkpoint the full train state (weights and buffers, Adam's
        moments, step and learning rate) plus the monitor's bookkeeping
        and the host and dropout RNG states, for an exact resume. Under a
        mesh it is one device's state, written by rank 0."""
        from .checkpoint import save_train_state
        mode, bits, pos, has_gauss, gauss = self._shuffle_rng.get_state()
        extra = {
            "best_metric": float(getattr(self, "_best_metric", -np.inf)),
            "stopping_steps": int(getattr(self, "_stopping_steps", 0)),
            "total_batches": int(getattr(self, "_total_batches", 0)),
            "shuffle_rng": [mode, bits.tolist(), int(pos), int(has_gauss), float(gauss)],
            "dropout_rng": self.dropout_generator.get_state().tolist(),
        }
        model_state, opt_state = self.model_state(), self._optimizer_state()
        on_rank0(self.mesh, lambda: save_train_state(path, model_state, opt_state, extra))

    def restore_train_state(self, path):
        """Load a state saved by :meth:`save_train_state`; the next
        ``fit`` continues its bookkeeping instead of starting afresh."""
        from .checkpoint import restore_train_state
        state, extra = from_rank0(
            self.mesh, lambda: restore_train_state(path, map_location="cpu"))
        self.load_model_state(state["model"])
        self._load_optimizer_state(state["optimizer"])
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
        """Write one device's state dict (under a mesh, gathered and
        written by rank 0)."""
        state = self.model_state()

        def write():
            os.makedirs(os.path.dirname(checkpoint) or ".", exist_ok=True)
            torch.save(state, checkpoint)
        on_rank0(self.mesh, write)

    def load_weights(self, checkpoint):
        state = from_rank0(self.mesh, lambda: torch.load(
            checkpoint, map_location="cpu", weights_only=True))
        self.load_model_state(state)
        logging.info("Loaded weights from %s", checkpoint)
