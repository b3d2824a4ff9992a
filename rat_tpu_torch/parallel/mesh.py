"""Device mesh of processes (port of rat_tpu.parallel.mesh).

A 2-D ``(data, model)`` mesh, as in the JAX package:

- the batch is sharded over ``data``: each data rank runs its
  contiguous slice of every global batch, and the gradients are summed
  over the data axis;
- the embedding tables are ROW-sharded over ``model``: each model rank
  holds a contiguous range of rows, a lookup gathers the ids in its
  range and zeros the rest, and the partial rows are summed over the
  model axis (nn/embedding.py::RowShardedLookup); with a model axis of
  1 (pure data parallelism) the trainer keeps them whole;
- everything else is replicated.

JAX runs one program over all devices and XLA inserts the collectives.
Here a mesh of n devices is n processes, one device each, and every
collective is a ``torch.distributed`` call the code makes itself. Rank r
sits at (data r // m, model r % m) for a model axis of m, the row-major
layout of the JAX package's ``reshape(n // m, m)``.
"""

import os

import torch.distributed as dist

#: tables with at most this many rows stay replicated (the JAX rule)
_MIN_SHARDED_ROWS = 16


def parse_mesh_spec(spec):
    """Normalize a mesh spec to (data_axis, model_axis) or None:
    ``"4x2"`` -> (4, 2); ``8`` / ``"8"`` -> (8, 1);
    ``{"data": 4, "model": 2}``; ``None`` / ``""`` / ``"none"`` -> None."""
    if spec is None or spec == "" or str(spec).lower() == "none":
        return None
    if isinstance(spec, dict):
        return int(spec.get("data", 1)), int(spec.get("model", 1))
    text = str(spec).lower()
    if "x" in text:
        data, model = text.split("x", 1)
        return int(data), int(model)
    return int(text), 1


def mesh_axes(params=None, cli_spec=None):
    """The (data, model) axes asked for by, in precedence order, an
    explicit CLI spec, the config's ``mesh`` key or the RAT_TPU_MESH
    environment variable; None when none is set."""
    spec = cli_spec
    if spec is None and params is not None:
        spec = params.get("mesh")
    if spec is None:
        spec = os.environ.get("RAT_TPU_MESH")
    return parse_mesh_spec(spec)


def resolve_mesh(params=None, cli_spec=None):
    """The experiment's mesh from :func:`mesh_axes`, or None for the
    single-device path (no spec, or 1x1). Needs the process group of
    the mesh's size (parallel/distributed.py)."""
    axes = mesh_axes(params, cli_spec)
    if axes is None:
        return None
    data_axis, model_axis = axes
    if data_axis * model_axis <= 1:
        return None
    return make_mesh(n_devices=data_axis * model_axis, model_axis_size=model_axis)


class Mesh(object):
    """This process's place in a (data, model) mesh.

    ``data_group`` joins the ranks that share this rank's model index
    (they hold the same table rows and different batch slices: the
    gradients and the sharded pool scan reduce over it); ``model_group``
    joins the ranks that share its data index (they hold the same batch
    slice and different table rows: lookups reduce over it)."""

    def __init__(self, data, model, rank, device, data_group, model_group):
        self.data, self.model = data, model
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.device = device
        self.data_group, self.model_group = data_group, model_group

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def size(self):
        return self.data * self.model

    def barrier(self):
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def broadcast(self, obj):
        """Rank 0's picklable ``obj``, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0,
                                   device=self.device if self.device.type == "cuda"
                                   else None)
        return box[0]

    def __repr__(self):
        return "Mesh(data={}, model={}, rank={}, device={})".format(
            self.data, self.model, self.rank, self.device)


def make_mesh(n_devices=None, model_axis_size=1):
    """The mesh of this process group, on the device the group was
    started on: ``n_devices`` must be the world size (one device per
    process) and ``model_axis_size`` divide it."""
    from .distributed import process_device
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n != world:
        raise ValueError("a mesh of {} devices needs {} processes, the world "
                         "has {}".format(n, n, world))
    if model_axis_size < 1 or n % model_axis_size:
        raise ValueError("model axis {} does not divide {} devices".format(
            model_axis_size, n))
    m = model_axis_size
    data_group = model_group = None
    # every rank creates every group, in the same order
    for j in range(m):
        group = dist.new_group(list(range(j, n, m)))
        if rank % m == j:
            data_group = group
    for i in range(n // m):
        group = dist.new_group(list(range(i * m, (i + 1) * m)))
        if rank // m == i:
            model_group = group
    return Mesh(n // m, m, rank, process_device(), data_group, model_group)


def is_row_sharded(name, tensor):
    """Whether parameter ``name`` is row-sharded over ``model``: a 2-D
    ``table`` under an ``embedding_layer`` name with more than 16 rows,
    not the label table (the JAX package's embedding_table_shapes). In
    RATModel: ``embedding_layer.table`` and the wide tower's
    ``lr_layer.embedding_layer.table``. Optimizer moments follow their
    parameter."""
    parts = name.split(".")
    return (parts[-1] == "table"
            and any("embedding_layer" in p for p in parts)
            and not any("label" in p for p in parts)
            and tensor.dim() == 2 and tensor.shape[0] > _MIN_SHARDED_ROWS)


def embedding_table_shapes(model):
    """The set of shapes of the row-shardable tables (:func:`is_row_sharded`)
    of ``model``: the JAX package's embedding_table_shapes, which gives
    the same set over the same model's flax params."""
    return {tuple(t.shape) for name, t in model.named_parameters()
            if is_row_sharded(name, t)}


def shard_range(n_rows, parts, index):
    """Rows [lo, hi) of part ``index`` when ``n_rows`` are cut into
    ``parts`` contiguous parts of ceil(n_rows / parts) rows (the last
    ones may be shorter or empty)."""
    per = -(-n_rows // parts)
    lo = min(index * per, n_rows)
    return lo, min(lo + per, n_rows)
