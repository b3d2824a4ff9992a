"""Process-group bring-up and per-rank batch slicing (port of
rat_tpu.parallel.distributed).

One process per device: ``nccl`` between CUDA devices, ``gloo`` on the
CPU. :func:`initialize_distributed` joins the group that ``torchrun``
describes in the environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or one given explicitly, with a finite
timeout, so that a lost rank fails the run instead of hanging it.
:func:`launch` starts one worker per device itself, as the CLI does
when no group exists yet.

Each rank loads every split and computes the same global batches; it
then runs its own contiguous slice of each (:func:`process_local_rows`).
The JAX package's ``host_local_*_to_global`` helpers, which assemble a
global array from each host's rows, have no counterpart: a process here
only ever holds its local tensors, and the collectives it needs are
written out where they run. The ``[G, B]`` index-group variant goes with
the grouped ``lax.scan`` dispatch, which the port leaves out.

Multi-host runs take the same path (give every host MASTER_ADDR), but
have not been run on cards; caches and checkpoints are written by rank
0 and read back by every rank, so hosts must share the file system.
"""

import datetime
import os
import socket

import torch
import torch.distributed as dist

#: seconds a collective may wait for a peer before the run fails
TIMEOUT_S = 900

_state = {"device": None}


def initialize_distributed(device=None, init_method=None, world_size=None,
                           rank=None, timeout_s=TIMEOUT_S):
    """Join (or start) the process group; idempotent. Without
    ``init_method`` the ``torchrun`` environment is read (``env://``).
    ``device``: this rank's device; None means ``cuda:LOCAL_RANK``.
    The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU;
    a collective that waits ``timeout_s`` seconds for a peer fails.
    Returns (world size, rank)."""
    if device is None:
        device = "cuda:{}".format(int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for a "
                               "gloo group on the CPU")
        torch.cuda.set_device(device)
    _state["device"] = device
    if not dist.is_initialized():
        kwargs = {}
        if world_size is not None:
            kwargs.update(world_size=int(world_size), rank=int(rank))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method or "env://",
                                timeout=datetime.timedelta(seconds=timeout_s),
                                **kwargs)
    return dist.get_world_size(), dist.get_rank()


def process_device():
    """The device :func:`initialize_distributed` gave this process."""
    if _state["device"] is None:
        raise RuntimeError("no device: call initialize_distributed first")
    return _state["device"]


def process_local_rows(batch_indices, mesh):
    """This rank's contiguous slice of a global batch of row ids (numpy
    or torch): data rank i of d takes rows [i B/d, (i+1) B/d). The batch
    must divide over the data axis — dropping the remainder would train
    and evaluate on fewer rows than the step's ``valid`` divisor assumes.
    The loaders pad every batch to ``batch_size``, so this only fires on
    misconfiguration."""
    k, i = mesh.data, mesh.data_index
    if len(batch_indices) % k:
        raise ValueError(
            "batch of {} rows does not divide over {} processes; pick a "
            "batch_size that is a multiple of the process count".format(
                len(batch_indices), k))
    per = len(batch_indices) // k
    return batch_indices[i * per: (i + 1) * per]


def from_rank0(mesh, fn):
    """``fn()`` run on rank 0 only and its (picklable) value broadcast to
    every rank; without a mesh, ``fn()``. Ranks take one branch around a
    collective this way, and only rank 0 reads a file it wrote."""
    if mesh is None:
        return fn()
    return mesh.broadcast(fn() if mesh.rank == 0 else None)


def on_rank0(mesh, fn):
    """Run ``fn()`` on rank 0 only (a write), then wait for it on every
    rank."""
    if mesh is None or mesh.rank == 0:
        fn()
    if mesh is not None:
        mesh.barrier()


def free_port():
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world_size, port, devices, args):
    initialize_distributed(devices[rank], "tcp://localhost:{}".format(port),
                           world_size, rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn, devices, args=()):
    """Run ``fn(*args)`` in one spawned process per entry of ``devices``
    (rank r on ``devices[r]``), each inside the process group of all of
    them; returns when every worker has ended and raises if any failed.
    ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    mp.spawn(_entry, args=(fn, len(devices), free_port(),
                           [str(d) for d in devices], tuple(args)),
             nprocs=len(devices), join=True)
