"""Training and eval runtime (port of rat_tpu.engine.trainer, single
device). Control flow as in the JAX package and the reference
(fuxictr base_model.py:74-230):

- loss = BCE (torch's ``F.binary_cross_entropy``: log terms clamped at
  -100, a finite gradient at a prediction of 0 or 1) over the batch,
  plus the p-norm regularizers split embedding-vs-net by parameter
  name;
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

Dispatch is grouped, as in the JAX package (trainer.py:689-966), in one
train loop: it buffers ``train_scan_batches`` batches (default 64; the
environment variable RAT_TPU_TRAIN_SCAN_BATCHES overrides the key, and
1 or less means groups of one batch) and dispatches each buffer as one
:meth:`Trainer.train_scan` with one [G, B] index upload (pinned,
non-blocking on a card). A group never spans an evaluation boundary or
a change of device split, so the batches before such a boundary form a
shorter group, dispatched as a full one is. Evaluation groups 64
batches per dispatch and keeps at most 8 groups in flight before it
fetches the oldest. On a card every train batch replays a CUDA graph of
the train step's forward and backward (but a new graph's first, which
runs eagerly), the optimizer stepping eagerly after each replay, and
every eval batch one of the eval forward (engine/step_graph.py), K1
inside, under a mesh (its collectives captured) and with
``dedup_neighbors`` too, unless :meth:`Trainer._graph_gate` says why
not (the CPU, a profiling epoch, dropout without
``register_generator_state``); those runs group their dispatch all the
same and run each step eagerly. A profiling epoch runs groups of one
batch. The full train state (``save_train_state``/
``restore_train_state``, engine/checkpoint.py) resumes a run exactly.
``profile_dir`` writes a torch.profiler trace of steps 2 to 2 +
``profile_steps`` of the first epoch, and beside it the program's spans
recorded meanwhile (rat_tpu_torch.tracing: the epoch, the dispatch,
captures, replays, the optimizer's eager steps, the evaluation and the
checkpoint each record one). ``dedup_neighbors`` (or
RAT_TPU_DEDUP_NEIGHBORS=1) gathers each batch's pool rows once per
distinct row and expands them with the inverse index of a fixed-size
unique: the same grid, at shapes that do not depend on the data.

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

import json
import logging
import os
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import tracing
from ..data.block_loader import DataBlockGenerator
from ..metrics import evaluate_metrics
from ..models import build_model, rat_m2_fast_forward
from ..nn.embedding import PackedEmbedding
from ..nn.layers import Dropout, set_batch_norm_group, set_dropout_generator
from ..parallel import (from_rank0, is_row_sharded, on_rank0, process_local_rows,
                        shard_range)
from ..utils import Monitor, resolve_device
from .optim import (get_learning_rate, get_optimizer, regularization_loss,
                    set_learning_rate)
from .step_graph import StepGraph


def _bce(pred, target):
    """Elementwise binary cross-entropy: torch's
    ``F.binary_cross_entropy`` (the published trainer's loss), value and
    gradient. Each log term is clamped at -100, and the gradient's
    denominator p (1 - p) is bounded below by 1e-12, so that a float32
    prediction of exactly 0 or 1 gives a finite loss and gradient (at p
    = 1: 0 for target 1, 1e12 for target 0, which the sigmoid's p (1 - p)
    takes to 0). The JAX package clamps the logs alone
    (rat_tpu/engine/trainer.py:50-54), and its gradient there is 0 x inf
    = NaN, which turns the weights NaN at the next step; and it takes
    log(1 - p) where torch takes log1p(-p). So the two differ only where
    p or 1 - p rounds away in float32: a saturated row."""
    return F.binary_cross_entropy(pred, target, reduction="none")


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


def fixed_size_unique(ids):
    """``jnp.unique(ids.reshape(-1), return_inverse=True, size=n,
    fill_value=0)`` for the n = ids.numel() integer ids: (the sorted
    distinct ids, then zeros, [n]; the inverse, of ``ids``' shape, with
    ``unique[inverse] == ids``). Its shapes do not depend on the values
    and nothing waits on the host, so a CUDA graph can hold it: a stable
    sort, a flag where the sorted value changes, its cumulative sum (each
    sorted id's slot) and two scatters, one back through the sort's
    permutation."""
    flat = ids.reshape(-1)
    ordered, perm = torch.sort(flat, stable=True)
    changed = torch.ones_like(ordered, dtype=torch.bool)
    changed[1:] = ordered[1:] != ordered[:-1]
    slot = torch.cumsum(changed, 0) - 1
    # the repeats of an id write the same value to its slot
    unique = torch.zeros_like(flat).scatter_(0, slot, ordered)
    inverse = torch.empty_like(slot).scatter_(0, perm, slot)
    return unique, inverse.reshape(ids.shape)


def _gather_batch(data, idx, dedup_neighbors=False):
    """Assemble the [B, 1+K, L] grid from device-resident split arrays.
    Returns (X tokens, y labels, X_num — the float values of the same
    columns, or None without numeric fields —, nbr_mask or None — the
    [B, 1+K] mask of the corrected ``neighbor_padding="mask"`` mode).
    ``dedup_neighbors`` gathers each distinct pool row once and expands
    with the inverse index (:func:`fixed_size_unique`, the JAX package's
    fixed-size unique): identical outputs."""
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
        uniq, inverse = fixed_size_unique(nb)

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


def _fetch_async(group):
    """Start copying an eval group's (y_pred, y_true, valid counts) to
    the host; on a card into pinned memory, without waiting."""
    pred, true, valids = group
    both = torch.stack([pred, true])
    if both.device.type != "cuda":
        return both, None, valids
    host = both.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done, valids


def _fetched(pending):
    """Wait for a copy started by :func:`_fetch_async`; returns host
    (y_pred [n, B], y_true [n, B], valid counts) as numpy."""
    host, done, valids = pending
    if done is not None:
        done.synchronize()
    host = host.numpy()
    return host[0], host[1], valids


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
        #: the captured step of each kind ("train", "eval"), see _graph
        self._graphs = {}
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
        with tracing.span("train.device_split") as sp:
            def up(arr, dtype):
                t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(
                    self.device)
                self._resident.add(t)
                sp.add(bytes=t.numel() * t.element_size())
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

    def step_path(self):
        """The counter of the path a train step takes now:
        ``model.path.fused`` (kernel K1, through the gate of
        :meth:`_use_fast_forward`) or ``model.path.module``."""
        return "model.path.fused" if self._use_fast_forward() else "model.path.module"

    def _forward(self, data, idx):
        """Gather one batch and run the fused or the module forward."""
        X, y, Xf, nmask = _gather_batch(data, idx, self._dedup)
        if self._use_fast_forward():
            return rat_m2_fast_forward(self.model, X, y, Xf)
        return self.model(X, y, Xf, nbr_mask=nmask)

    # ---- training ---------------------------------------------------------
    def loss_and_grads(self, data, idx, valid):
        """Forward and backward of one batch in training mode (idx: [B]
        device row ids, the first ``valid`` real, an int or a float32
        device scalar; under a mesh the GLOBAL batch, of which this rank
        runs its slice). The padded rows enter
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
        # times the float32 reciprocal of the count: the same number
        # whether ``valid`` is an int (a per-step call) or a device
        # scalar (a captured step), where a division would differ
        loss = torch.sum(self._loss_fn(pred, target) * mask) * (1.0 / valid)
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
        tracing.count("train.eager_steps")
        tracing.count(self.step_path())
        with tracing.span("train.step"):
            loss = self.loss_and_grads(data, idx, valid)
            self.optimizer.step()
        return loss

    def _block_stream(self, views, rng=None):
        """(device data, row ids, valid count, last) for every batch of
        every block view, one block on the device at a time: a view is
        uploaded when its first batch is asked for, and the last batch
        (``last`` True) hands the caller the only reference to its
        buffers, so that the block is freed when the caller drops it,
        before the next upload. Row orders are drawn from ``rng`` block
        by block, after each block is loaded, as in the JAX package."""
        for view in views:
            box = [self.device_split(view, share_pool=False)]
            batches = list(view.epoch_index_batches(rng=rng))
            for i, (idx, valid) in enumerate(batches):
                last = i == len(batches) - 1
                yield (box.pop() if last else box[0]), idx, valid, last

    def _epoch_stream(self, train_gen):
        if self._block_mode:
            return self._block_stream(
                train_gen.iter_block_views(rng=self._shuffle_rng), self._shuffle_rng)
        if self._train_data is None:
            self._train_data = self.device_split(train_gen)
        return ((self._train_data, idx, valid, False) for idx, valid in
                train_gen.epoch_index_batches(rng=self._shuffle_rng))

    def _eval_stream(self, data_gen, data=None):
        if isinstance(data_gen, DataBlockGenerator):
            return self._block_stream(data_gen.iter_block_views())
        if data is None:
            data = self.device_split(data_gen)
        return ((data, idx, valid, False) for idx, valid in data_gen.epoch_index_batches())

    def fit(self, train_gen, validation_data=None, epochs=1):
        """Train for ``epochs``. A DataBlockGenerator train split streams
        block by block; a DataBlockGenerator valid split, or any valid
        split under ``lazy_valid_upload``, is uploaded per evaluation."""
        self.valid_gen = validation_data
        self._block_mode = isinstance(train_gen, DataBlockGenerator)
        self._graphs = {}    # a graph of an earlier fit holds its splits
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

    #: train batches per grouped dispatch (the JAX package's
    #: ``_TRAIN_SCAN_BATCHES``); config key ``train_scan_batches``, env
    #: RAT_TPU_TRAIN_SCAN_BATCHES over it, 1 or less for one batch a group
    _TRAIN_SCAN_BATCHES = 64

    def _train_group_size(self):
        """Batches per grouped train dispatch, read as the JAX package
        reads them; 0 (from 1 or less) for groups of one batch."""
        env = os.environ.get("RAT_TPU_TRAIN_SCAN_BATCHES")
        g = int(env) if env is not None else \
            int(self.params.get("train_scan_batches", self._TRAIN_SCAN_BATCHES))
        return g if g > 1 else 0

    def _has_dropout(self):
        return any(isinstance(m, Dropout) and m.p > 0 for m in self.model.modules())

    def _graph_gate(self, kind="train", profiling=False):
        """None when the grouped loops replay a CUDA graph of the ``kind``
        ("train" or "eval") step, else why they run it eagerly: the CPU;
        and for training a profiling epoch (its steps are traced
        eagerly) and dropout where this torch cannot register a
        generator with a graph. A mesh (its collectives captured) and
        ``dedup_neighbors`` (a fixed-size unique) take the graph."""
        if self.device.type != "cuda":
            return "the CPU"
        if kind == "train":
            if profiling:
                return "a profiling epoch"
            if self._has_dropout() and not hasattr(torch.cuda.CUDAGraph,
                                                   "register_generator_state"):
                return "dropout without CUDAGraph.register_generator_state"
        return None

    def train_dispatch(self, group, profiling=False):
        """How train steps dispatched in groups of ``group`` batches (0 or
        1: one) run, in words: whether a step graph is replayed, or the
        gate's reason why not."""
        reason = self._graph_gate("train", profiling)
        return "groups of {} batches, {}".format(
            max(group, 1), "step graph replayed" if reason is None
            else "no step graph ({})".format(reason))

    def _graph(self, kind, data, batch_size):
        """The ``kind`` step's graph over ``data``, captured anew when it
        is missing or was captured over another split, on the other
        path (fused or module) or in the other mode."""
        key = (self._use_fast_forward(), self.model.training, batch_size)
        graph = self._graphs.get(kind)
        if graph is None or graph.key != key or graph.data is not data:
            self._graphs.pop(kind, None)     # free the old one's pool first
            graph = self._graphs[kind] = StepGraph(self, kind, data, batch_size, key)
        return graph

    def _upload(self, array):
        """A host array on the device in one copy, pinned and
        non-blocking on a card."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def train_scan(self, data, idx_group, valid_group, eager=None):
        """G train steps in one dispatch, the counterpart of the JAX
        package's ``train_scan``: ``idx_group`` [G, B] device row ids,
        ``valid_group`` G valid counts, for any G. With the graph gate
        open (``eager`` None asks it; the epoch loop passes the answer it
        got once) the graph of the step's forward and backward is
        replayed per batch, the optimizer stepping eagerly after each (a
        new graph's first batch runs eagerly whole), else each batch runs
        :meth:`train_step`. Returns the [G] losses on the device."""
        self.model.train()
        if eager is None:
            eager = self._graph_gate("train") is not None
        if not eager:
            valids = self._upload(np.asarray(valid_group, np.float32))
            graph = self._graph("train", data, idx_group.shape[1])
            return graph.run(idx_group, valids)[0]
        return torch.stack([self.train_step(data, idx_group[i], int(v))
                            for i, v in enumerate(valid_group)])

    def train_one_epoch(self, train_gen, epoch):
        """Returns (epoch loss, examples, seconds). The epoch loss divides
        by the FULL batch count even when early stop cuts the epoch
        short (the reference's denominator, base_model.py:226-228). With
        ``profile_dir``, the first epoch runs groups of one batch without
        the graph, and its steps 2 to 2 + ``profile_steps`` are traced."""
        profiling = self._profile_dir is not None and epoch == 0
        group = 1 if profiling else max(self._train_group_size(), 1)
        eager = self._graph_gate("train", profiling) is not None
        logging.info("Train dispatch: %s", self.train_dispatch(group, profiling))
        self.model.train()
        tic = time.time()
        with tracing.span("train.epoch"):
            losses, examples = self._train_one_epoch_grouped(train_gen, group, eager,
                                                             profiling)
            step_losses = torch.cat([x.reshape(-1) for x in losses]).cpu().numpy()
        self.step_losses.extend(step_losses.tolist())
        epoch_secs = time.time() - tic
        # a float32 running sum, as the JAX package's
        return float(sum(step_losses)) / self._batches_per_epoch, examples, epoch_secs

    def _train_one_epoch_grouped(self, train_gen, group, eager, profiling):
        """Per-step semantics at grouped dispatch cost, by the JAX
        package's rules (trainer.py:758-833): batches are buffered and
        each buffer is dispatched as one :meth:`train_scan` (``eager``
        its answer for the epoch), once it holds ``group`` batches or
        reaches a boundary: a group never spans an evaluation boundary
        (evaluate() sees the state right after the boundary batch) or a
        change of device split (a block is released after its last
        batch). Then ``on_batch_end`` runs per batch, and early stop
        breaks at the same batch as with groups of one. ``profiling``
        traces batches 2 to 2 + ``profile_steps``, one a group. Returns
        (loss tensors, examples)."""
        losses = []
        examples = 0
        tic = last_beat = time.time()
        n_epoch, every_x = self._batches_per_epoch, self._every_x_batches
        pend = []          # buffered (idx, valid)
        cur = None         # the device split they gather from
        dispatched = 0     # batches dispatched this epoch
        profiler = None

        def finalize(release):
            """Dispatch the buffer, drop the split if ``release``, then
            run the per-batch bookkeeping."""
            nonlocal pend, cur, dispatched, examples, last_beat, profiler
            if not pend:
                return
            if profiling and dispatched == 2:
                profiler = self._start_profile()
            with tracing.span("train.group"):
                idx = self._upload(np.stack([i for i, _ in pend]).astype(np.int64))
                valids = [v for _, v in pend]
                losses.append(self.train_scan(cur, idx, valids, eager))
                del idx
            if profiler is not None and dispatched >= 2 + self._profile_steps:
                profiler = self._stop_profile(profiler)
            if release:
                cur = None
                self._graphs.pop("train", None)
            examples += sum(valids)
            n, pend = len(pend), []
            base, dispatched = dispatched, dispatched + n
            now = time.time()
            if now - last_beat >= 60.0:
                # a heartbeat, so that a long silent epoch is told from a
                # wedged one
                last_beat = now
                logging.info("epoch progress: %d/%d batches dispatched "
                             "(%.0f examples/s dispatch-side)", dispatched, n_epoch,
                             examples / max(now - tic, 1e-9))
            for i in range(n):
                self.on_batch_end(base + i)
                if self._stop_training:
                    break

        for data, idx, valid, last in self._epoch_stream(train_gen):
            if pend and data is not cur:
                finalize(True)
            if self._stop_training:
                break
            cur = data
            del data
            pend.append((idx, valid))
            b = dispatched + len(pend) - 1     # this batch's index in the epoch
            if last or len(pend) == group or (b + 1) % every_x == 0 \
                    or (b + 1) % n_epoch == 0:
                finalize(last)
                if self._stop_training:
                    break
        finalize(True)
        if profiler is not None:
            self._stop_profile(profiler)
        return losses, examples

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler):
        """Stop the trace and write it to ``profile_dir`` as
        ``trace_<pid>.json``, and the program's spans recorded meanwhile
        (rat_tpu_torch.tracing) beside it as ``spans_<pid>.json``, Chrome
        trace events on the trace's timebase; returns None."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        pid = os.getpid()
        path = os.path.join(self._profile_dir, "trace_{}.json".format(pid))
        profiler.export_chrome_trace(path)
        logging.info("Profiler trace written to {}".format(path))
        with open(path) as fh:
            # the ns its microseconds count from; absent, they are absolute
            base = json.load(fh).get("baseTimeNanoseconds", 0)
        events = tracing.chrome_events(tracing.take(), base, pid, threading.get_native_id())
        spans_path = os.path.join(self._profile_dir, "spans_{}.json".format(pid))
        with open(spans_path, "w") as fh:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": base}, fh)
        logging.info("Program spans written to {}".format(spans_path))
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
        with tracing.span("train.checkpoint"):
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
    #: eval batches per grouped dispatch (the JAX package's)
    _EVAL_SCAN_BATCHES = 64

    def _eval_dispatch(self, data_gen, data=None):
        """Dispatch the whole set asynchronously, ``_EVAL_SCAN_BATCHES``
        batches per group, with one index upload per group; a group never
        spans two device splits. Yields (y_pred [n, B'], y_true [n, B']
        on the device, the n valid counts) per group, B' being this
        rank's slice under a mesh. With the graph gate open each batch
        replays the eval forward's graph (a new graph's first batch runs
        eagerly), else runs it eagerly."""
        group = self._EVAL_SCAN_BATCHES
        graphed = self._graph_gate("eval") is None
        cur, ids, valids = None, [], []

        def flush(release):
            nonlocal cur
            with tracing.span("eval.dispatch"):
                idx = self._upload(np.stack(ids).astype(np.int64))
                if graphed:
                    pred, true = self._graph("eval", cur, idx.shape[1]).run(idx)
                else:
                    outs = [self._forward(cur, row if self.mesh is None
                                          else process_local_rows(row, self.mesh))
                            for row in idx]
                    pred = torch.stack([o["y_pred"][:, 0] for o in outs])
                    true = torch.stack([o["y_true"][:, 0] for o in outs])
            if release:
                cur = None
                self._graphs.pop("eval", None)
            return pred, true, list(valids)

        for split_data, idx, valid, last in self._eval_stream(data_gen, data):
            if ids and split_data is not cur:
                yield flush(True)
                ids, valids = [], []
            cur = split_data
            del split_data
            ids.append(idx)
            valids.append(valid)
            if last or len(ids) == group:
                yield flush(last)
                ids, valids = [], []
        if ids:
            yield flush(False)

    #: dispatched eval groups pending before the oldest is fetched (the
    #: JAX package's): bounds the host and device memory they pin while
    #: the device stays several groups ahead of the host
    _EVAL_MAX_INFLIGHT_GROUPS = 8

    @torch.no_grad()
    def _eval_collect(self, data_gen, data=None):
        """Score every batch in eval mode (a DataBlockGenerator block by
        block) through :meth:`_eval_dispatch`, each group's copy to the
        host started when it is dispatched and waited for when more than
        ``_EVAL_MAX_INFLIGHT_GROUPS`` are pending, oldest first; returns
        host (y_pred, y_true) float32 of the valid rows."""
        training = self.model.training
        self.model.eval()
        pending = deque()
        preds, trues, groups = [], [], []

        def drain_one():
            with tracing.span("eval.drain"):
                pred, true, valids = _fetched(pending.popleft())
            for i, v in enumerate(valids):
                preds.append(pred[i][:v])
                trues.append(true[i][:v])

        for group in self._eval_dispatch(data_gen, data):
            if self.mesh is not None:
                groups.append(group)     # gathered over the data group below
                continue
            pending.append(_fetch_async(group))
            if len(pending) > self._EVAL_MAX_INFLIGHT_GROUPS:
                drain_one()
        while pending:
            drain_one()
        self.model.train(training)
        if data is None or data is not getattr(self, "_valid_data", None):
            self._graphs.pop("eval", None)    # its split is this call's own
        if self.mesh is None:
            return np.concatenate(preds), np.concatenate(trues)
        return self._gather_predictions([p for g in groups for p in g[0]],
                                        [t for g in groups for t in g[1]],
                                        [v for g in groups for v in g[2]])

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
        with tracing.span("eval"):
            y_pred, y_true = self._eval_collect(data_gen, data)
            with tracing.span("eval.metrics"):
                return evaluate_metrics(y_true.astype(np.float64),
                                        y_pred.astype(np.float64),
                                        self._validation_metrics)

    def predict(self, data_gen, data=None):
        with tracing.span("eval"):
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
        self._graphs = {}
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
