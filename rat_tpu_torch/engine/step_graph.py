"""CUDA graphs of the Trainer's train step and eval forward: the port's
counterpart of the JAX package's scanned dispatch (``train_scan`` and
``eval_scan``, rat_tpu/engine/trainer.py:528-571).

JAX folds a group of G steps into one ``lax.scan`` program. Here one
graph holds ONE step at the batch size, and the Trainer's grouped loops
replay it once per batch of a group: the host enqueues a replay and a
few copies per batch instead of the forward's and backward's hundreds
of kernel launches, and never waits for the card inside a group.

- **What a train graph holds.** The forward, the masked loss with the
  regularizer, and the backward (``Trainer.loss_and_grads``). The
  optimizer's ``step()`` (the global-norm clip, then the rule) runs
  eagerly after each replay, on the gradients the graph wrote: its
  learning rate and step count stay host values, read at every step,
  so the LR plateau reaches the next replayed step, every optimizer
  rule takes the graph, and a graphed step does the per-step path's
  arithmetic. (A capturable Adam, whose step count and rate live on
  the device, computes its bias corrections in float32 on the device:
  another arithmetic, which moved the reduced-precision gate's float32
  and TF32 fits apart.)
- **Static inputs.** The step reads ``idx`` [B] (the global batch's
  row ids) and, in training, ``valid`` (the batch's real rows, a float32
  device scalar, so that the padded last batch goes through the same
  graph, as in JAX's scan). Each batch's values are copied into them
  before its replay. Under a mesh each rank's step reads its slice of
  ``idx`` (``process_local_rows``: a view of the buffer).
- **Static outputs.** A replay overwrites the captured outputs (the
  loss; the predictions and labels, this rank's rows under a mesh), so
  :meth:`StepGraph.run` copies each replay's outputs into the group's
  stacked buffers.
- **Warm-up.** A capture runs nothing. A new graph's first batch runs
  eagerly on the capture's own stream (a real step: cuBLAS's workspace
  for that stream, K1's launch plan and, under a mesh, the NCCL
  communicator of every group the step reduces over exist before the
  capture), and the batches after it replay the graph, so no batch is
  applied twice or skipped.
- **Under a process group.** The collectives of the forward and the
  backward are captured: the gradients' all-reduce over the data group
  and the reported loss's over the world (Trainer._mesh_backward),
  BatchNorm's statistics and the row-sharded lookups' sums
  (nn/layers.py::_AllReduceSum, nn/embedding.py::RowShardedLookup, the
  backward's from autograd's device thread). What this torch's
  ProcessGroupNCCL needs (torch 2.11, NCCL 2.28.9, a one-rank group on
  an H100): (1) the communicator must exist: NCCL creates it at a
  group's first collective, and that creation inside a capture fails
  ("operation not permitted when stream is capturing"), hence the
  eager warm-up, which runs every collective of the step; (2) nothing
  else: with the default capture mode, the watchdog and its
  asynchronous error handling on and the communicators created lazily,
  a capture after the warm-up holds the collectives and its replays
  give the eager values, so parallel/distributed.py sets no variable
  for it (turning the error handling off, as older torch releases
  asked, is not needed); (3) captured and
  eager collectives share a communicator: the clip's all-reduce over the
  model group (Trainer._mesh_grad_sq_norm) runs eagerly after each
  replay, and the evaluation's all-gather after the replays
  (Trainer._gather_predictions), ordered on the stream after them;
  NCCL_GRAPH_MIXING_SUPPORT must keep its default, 1. Every rank
  captures at the same batch of the same group, so the collectives
  meet in one order. A capture over two or more ranks has not run (one
  card holds one rank).
- **Dropout.** The Trainer's dropout generator is registered with a
  train graph (``CUDAGraph.register_generator_state``), so each replay
  draws the masks the eager step would have drawn.
- **K1's launches.** A capture records K1's launches (counted in
  ``cross_intra_block.captured``, not ``launches``); each replay adds
  the graph's count to ``cross_intra_block.launches``, which so stays
  the number of K1 launches run on the card. The same holds for K1's
  backward (``grad_captured``, ``grad_launches``), and each replay adds
  the graph's plain backward calls to ``grad_plain``.
- **Gradients.** The backward writes the gradients into the graph's
  memory pool; each replay hands those tensors back to the parameters'
  ``.grad`` before the optimizer steps, since a per-step call in between
  (a remainder batch) replaces them.
- **Lifetime.** A graph points at its device split, the parameters and
  buffers, and its own memory pool. It holds its split, and the Trainer
  drops it (Trainer._graph) when the split changes, when weights are
  loaded, and when the model's mode or path is not the one it was
  captured in. A capture that fails raises; nothing falls back to the
  eager step.
"""

import torch

from .. import tracing
from ..ops import cross_intra_block as k1
from ..parallel import process_local_rows


class StepGraph(object):
    """One captured step of ``trainer`` over the device split ``data``.

    ``kind`` "train": :meth:`Trainer.loss_and_grads` (forward, masked
    loss plus the regularizer, backward) -> the loss, each replay
    followed by the optimizer's eager step. ``kind`` "eval": the forward
    under ``torch.no_grad`` in eval mode -> (y_pred [B], y_true [B]).
    ``key`` is what the Trainer compares to decide whether the graph
    still fits."""

    def __init__(self, trainer, kind, data, batch_size, key):
        device = trainer.device
        self.trainer, self.kind, self.data, self.key = trainer, kind, data, key
        self.idx = torch.zeros(batch_size, dtype=torch.int64, device=device)
        self.valid = torch.zeros((), dtype=torch.float32, device=device)
        # no stream on the CPU, where no graph is captured but the step
        # runs all the same
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.warm = False
        self.graph = None
        self.outputs = None
        self.grads = []          # (parameter, its gradient in the pool)
        self.k1_per_replay = 0
        self.k1_grad_per_replay = self.k1_plain_per_replay = 0
        self.replays = 0
        # a replay's span and counter names (rat_tpu_torch.tracing), made
        # once: a replay runs per batch
        self._replay_span, self._replays = "graph.replay." + kind, "graph.replays." + kind

    def _step(self, captured):
        """The outputs of one step; in training the whole step when run
        eagerly, its forward and backward when ``captured``."""
        t = self.trainer
        if self.kind == "train":
            if captured:
                return (t.loss_and_grads(self.data, self.idx, self.valid),)
            return (t.train_step(self.data, self.idx, self.valid),)
        idx = self.idx if t.mesh is None else process_local_rows(self.idx, t.mesh)
        with torch.no_grad():
            out = t._forward(self.data, idx)
        return out["y_pred"][:, 0], out["y_true"][:, 0]

    def _capture(self):
        tracing.count("graph.captures." + self.kind)
        with tracing.span("graph.capture." + self.kind):
            graph = torch.cuda.CUDAGraph()
            if self.kind == "train" and self.trainer._has_dropout():
                graph.register_generator_state(self.trainer.dropout_generator)
            before = (k1.captured, k1.grad_captured, k1.grad_plain)
            with torch.cuda.graph(graph, stream=self.stream):
                outputs = self._step(captured=True)
        self.k1_per_replay = k1.captured - before[0]
        self.k1_grad_per_replay = k1.grad_captured - before[1]
        self.k1_plain_per_replay = k1.grad_plain - before[2]
        self.graph, self.outputs = graph, outputs
        self.grads = [(p, p.grad) for p in self.trainer.model.parameters()
                      if p.grad is not None]

    def run(self, idx, valids=None):
        """The step once per row of ``idx`` [n, B] (device row ids; in
        training ``valids`` [n] float32 on the device): eagerly for a new
        graph's first batch, then captured, then replayed. Returns each
        output stacked over the n batches: ([n] losses,) in training,
        ([n, B'] y_pred, [n, B'] y_true) in evaluation (B' this rank's
        rows)."""
        n, batch = idx.shape
        mesh = self.trainer.mesh
        rows = batch if mesh is None else batch // mesh.data
        shapes = [(n,)] if self.kind == "train" else [(n, rows), (n, rows)]
        outs = tuple(torch.empty(shape, dtype=torch.float32, device=idx.device)
                     for shape in shapes)
        current = torch.cuda.current_stream(idx.device)
        for i in range(n):
            self.idx.copy_(idx[i])
            if valids is not None:
                self.valid.copy_(valids[i])
            if self.graph is None and self.warm:
                self._capture()
            if self.graph is None:
                # the warm-up: a real step on the capture's stream, ordered
                # after the current stream's work and before its next
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    for o, r in zip(outs, self._step(captured=False)):
                        o[i].copy_(r)
                current.wait_stream(self.stream)
                self.warm = True
                continue
            with tracing.span(self._replay_span):
                self.graph.replay()
                for o, r in zip(outs, self.outputs):
                    o[i].copy_(r)
            self.replays += 1
            tracing.count(self._replays)
            k1.launches += self.k1_per_replay
            k1.grad_launches += self.k1_grad_per_replay
            k1.grad_plain += self.k1_plain_per_replay
            if self.kind == "train":
                with tracing.span("train.optim"):
                    for p, grad in self.grads:
                        p.grad = grad
                    self.trainer.optimizer.step()
        return outs
