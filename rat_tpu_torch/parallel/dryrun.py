"""Multi-device dry run on tiny shapes (the port's counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``), and the flagship
model's forward with example arguments (``entry``, the counterpart of
``__graft_entry__.entry``).

    python -m rat_tpu_torch.parallel.dryrun N [--cpu]

starts N processes (rank r on ``cuda:r`` over NCCL; with ``--cpu``, on
the CPU over gloo) in a (N/2 x 2) mesh when N is even, else (N x 1), and
on it runs: one train step and one eval step; the weights round trip
and the full-train-state round trip, every leaf equal after them; the
``dedup_neighbors`` and ``neighbor_padding: mask`` variants, with the
same first-step loss. N = 1 still builds a real one-rank mesh, so that
the mesh code path is what runs. Rank 0 prints one line ending in OK.
"""

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from ..data.loader import SplitBatches
from ..engine import Trainer
from ..features import FeatureMap
from ..models import build_model
from ..utils import resolve_device
from .distributed import launch
from .mesh import make_mesh, resolve_mesh


def tiny_feature_map(n_users=64, n_items=48, n_tags=32):
    fm = FeatureMap("graft_tiny", ".")
    fm.feature_specs = {
        "user_id": {"source": "", "type": "categorical", "vocab_size": n_users, "index": 0},
        "item_id": {"source": "", "type": "categorical", "vocab_size": n_items, "index": 1},
        "tag_id": {"source": "", "type": "categorical", "vocab_size": n_tags, "index": 2},
    }
    fm.num_fields = 3
    fm.num_features = n_users + n_items + n_tags
    fm.input_length = 3
    return fm


def tiny_params(**over):
    params = {
        "model": "RAT_m2", "model_id": "graft", "model_root": "./exps/",
        "embedding_dim": 10, "dnn_hidden_units": [64, 64],
        "dnn_activations": "relu", "num_heads": 2, "dim_head": 10,
        "depth": 2, "scale_dim": 4, "dropout": 0.0, "emb_dropout": 0.0,
        "net_dropout": 0.0, "batch_norm": False, "use_wide": True,
        "embedding_regularizer": 0.03, "net_regularizer": 0,
        "learning_rate": 1e-3, "optimizer": "adam", "seed": 2021,
        "metrics": ["AUC", "logloss"],
    }
    params.update(over)
    return params


class TinySplit(SplitBatches):
    """An n-row split of ``fields`` ids below 32 and random labels, with
    k random neighbours from itself, in batches of ``batch`` rows (the
    arrays of the JAX package's mesh tests for the same seed)."""

    def __init__(self, n=64, k=5, fields=3, batch=16, seed=0, shuffle=False):
        rng = np.random.RandomState(seed)
        self.darray = np.concatenate([rng.randint(0, 32, (n, fields)),
                                      rng.randint(0, 2, (n, 1))], axis=1).astype(np.float64)
        self.pool_darray = self.darray
        self.retr_indices = rng.randint(0, n, (n, k)).astype(np.int64)
        self.retr_lens = np.full(n, k)
        self.retrieval_augmented = True
        self.batch_size, self.shuffle = batch, shuffle
        self.num_samples = n
        self.num_batches = -(-n // batch)


def entry(device=None):
    """(forward, (model, X, y)): the eval forward of the flagship model
    (RAT_m2 at the tiny map's and params' widths, depth 2) and example
    arguments, 8 requests with 5 neighbours each drawn as the JAX
    package's ``__graft_entry__.entry`` draws them, on ``device`` (None:
    the card). ``forward(model, X, y)`` returns the [8, 1] predictions."""
    device = resolve_device(device)
    model = build_model(tiny_feature_map(), tiny_params()).to(device).eval()
    rng = np.random.RandomState(0)
    B, K, F = 8, 5, 3
    X = torch.from_numpy(rng.randint(0, 32, (B, 1 + K, F)).astype(np.int64)).to(device)
    y = torch.from_numpy(rng.randint(0, 2, (B, 1 + K)).astype(np.float32)).to(device)

    def forward(model, X, y):
        return model(X, y)["y_pred"]

    return forward, (model, X, y)


def one_step(trainer, data, idx, valid):
    """One train step from the trainer's weights: (loss, {name: gradient},
    {name: weight or buffer after the update}), the gradients and state
    as one device holds them (under a mesh, the sharded tables gathered
    over the model group; every rank must call it), on the CPU."""
    loss = float(trainer.loss_and_grads(data, idx, valid))
    grads = {}
    for name, p in trainer.model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach()
        if name in trainer._sharded:
            g = trainer._gather_rows(g, trainer._sharded[name][0])
        grads[name] = g.cpu().clone()
    trainer.optimizer.step()
    state = {k: v.detach().cpu().clone() for k, v in trainer.model_state().items()}
    return loss, grads, state


def local_leaves(trainer):
    """This rank's model and optimizer tensors, in a fixed order."""
    leaves = [t.detach().cpu().clone() for t in trainer.model.state_dict().values()]
    for slot in trainer.optimizer.state_dict()["state"].values():
        leaves += [v.detach().cpu().clone() for _, v in sorted(slot.items())
                   if torch.is_tensor(v)]
    return leaves


def dryrun_on_mesh(mesh):
    """The dry run's checks on this rank of ``mesh``; returns the
    summary line (the same on every rank)."""
    fm, gen = tiny_feature_map(), TinySplit()
    B = gen.batch_size
    idx = torch.arange(B, device=mesh.device)
    trainer = Trainer(fm, tiny_params(), mesh=mesh)
    data = trainer.device_split(gen)
    loss = float(trainer.train_step(data, idx, B))
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss {}".format(loss))
    pred = trainer.predict(gen, data)
    if pred.shape != (gen.num_samples,) or not np.isfinite(pred).all():
        raise AssertionError("eval step: predictions {}".format(pred.shape))

    tmp = mesh.broadcast(tempfile.mkdtemp() if mesh.rank == 0 else None)
    try:
        ckpt = os.path.join(tmp, "dryrun.model")
        trainer.save_weights(ckpt)
        trainer.load_weights(ckpt)
        if not np.array_equal(pred, trainer.predict(gen, data)):
            raise AssertionError("weights round trip changed the predictions")
        full = os.path.join(tmp, "full_state")
        before = local_leaves(trainer)
        trainer.save_train_state(full)
        trainer.restore_train_state(full)
        after = local_leaves(trainer)
        if len(before) != len(after) or not all(torch.equal(a, b)
                                                for a, b in zip(before, after)):
            raise AssertionError("full-state round trip changed a leaf")
        loss2 = float(trainer.train_step(data, idx, B))
        if not np.isfinite(loss2):
            raise AssertionError("non-finite loss after the restore")
    finally:
        mesh.barrier()
        if mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)

    dedup = Trainer(fm, tiny_params(dedup_neighbors=True), mesh=mesh)
    loss_d = float(dedup.loss_and_grads(dedup.device_split(gen), idx, B))
    if abs(loss_d - loss) >= 1e-6:
        raise AssertionError("dedup_neighbors loss {} against {}".format(loss_d, loss))
    masked = Trainer(fm, tiny_params(neighbor_padding="mask"), mesh=mesh)
    data_m = masked.device_split(gen)
    if "nbr_ok" not in data_m:
        raise AssertionError("mask mode uploaded no neighbour mask")
    loss_m = float(masked.loss_and_grads(data_m, idx, B))
    if abs(loss_m - loss) >= 1e-5:
        raise AssertionError("neighbor_padding=mask loss {} against {}".format(loss_m, loss))
    return ("dryrun_multichip({}): mesh={} loss={:.4f} eval+ckpt+full_state+dedup({:.4f})"
            "+mask({:.4f}) OK".format(mesh.size, mesh.shape, loss, loss_d, loss_m))


def _worker(n_devices):
    model_axis = 2 if n_devices % 2 == 0 else 1
    mesh = resolve_mesh({"mesh": "{}x{}".format(n_devices // model_axis, model_axis)})
    if mesh is None:
        # 1x1 means no mesh to the CLI; the dry run still wants one
        mesh = make_mesh(1, 1)
    line = dryrun_on_mesh(mesh)
    if mesh.rank == 0:
        print(line, flush=True)


def dryrun_multichip(n_devices, device="cuda"):
    """Run the dry run on ``n_devices`` processes: rank r on ``cuda:r``
    (NCCL), raising when there are fewer cards than ranks, or each on
    the CPU (gloo) with ``device="cpu"``."""
    if device == "cuda":
        if n_devices > torch.cuda.device_count():
            raise RuntimeError("{} ranks need {} CUDA devices, {} present; pass "
                               "device='cpu' (--cpu) for gloo ranks on the CPU".format(
                                   n_devices, n_devices, torch.cuda.device_count()))
        devices = ["cuda:{}".format(r) for r in range(n_devices)]
    elif device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        raise ValueError("device must be 'cuda' or 'cpu', not {!r}".format(device))
    launch(_worker, devices, (n_devices,))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU instead of one card per rank")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
