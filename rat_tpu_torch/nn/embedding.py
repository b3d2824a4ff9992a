"""Packed embedding stack (port of rat_tpu.nn.embedding).

All categorical and sequence fields share ONE packed [total_rows, d]
table with static per-field row offsets; a forward pass is a single
gather over every token column (categorical fields contribute one
token, sequence fields ``max_len`` tokens), then sequence spans are
pooled. Semantics, as in the JAX package:

- ``share_embedding`` fields alias the owner's rows;
- padding ids embed to exact zeros (the gathered vectors are masked
  with ``id != padding_idx``);
- sequence encoders MaskedAveragePooling / MaskedSumPooling, the
  average over the non-padding tokens;
- a numeric field embeds as ``value * w`` with one Xavier-normal
  d-vector ``w`` per field (``numeric_weights`` [n_num, d]);
- pretrained rows (``pretrained_emb``, an h5 file under the feature
  map's ``data_dir`` holding one dataset per field) are loaded into the
  packed table at construction; a frozen field (``freeze_emb``, the
  default) has its gathered vectors detached, while the table stays a
  parameter, so the embedding regularizer still moves those rows;
- a pretrained field whose width differs from the model's gets its own
  side table ``side_{name}`` and a bias-free projection
  ``hook_{name}`` to the model's width.

Every parameter lives under the module, so its name holds
"embedding_layer", the key of the embedding regularizer.

Each lookup of a table that takes a gradient (the packed table, the side
tables, the label table) is ``ops.embedding_grad.lookup``: ``table[rows]``,
whose backward on the card is a hand-written kernel that sums each
repeated id's rows in segments instead of one after another.

Under a mesh the packed table is row-sharded over the model axis
(:meth:`PackedEmbedding.shard_rows`): each rank keeps a contiguous range
of rows, and :class:`RowShardedLookup` gathers the ids in that range,
zeros the others and sums the partial vectors over the model group.
"""

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.embedding_grad import lookup, table_grad
from .initializers import embedding_init, xavier_normal


@dataclass(frozen=True)
class _FieldSpec:
    name: str
    kind: str                 # 'token' | 'seq' | 'numeric'
    token_slots: tuple        # slot positions in the packed token matrix
    x_cols: tuple             # column indices into the raw X matrix
    padding_idx: int          # local padding id, or -1
    encoder: Optional[str]    # pooling for sequences
    frozen: bool
    hook: bool                # pretrained-dim -> model-dim projection
    table_dim: int


@dataclass
class EmbeddingSpec:
    """Static layout compiled from a FeatureMap (a copy of the JAX
    package's, host-side numpy only)."""
    fields: List[_FieldSpec]
    total_rows: int
    token_cols: np.ndarray       # [T] X columns feeding the packed gather
    token_offsets: np.ndarray    # [T] per-token table row offsets
    token_padding: np.ndarray    # [T] local padding id or -1
    numeric_cols: np.ndarray     # [n_num] X columns of numeric fields
    num_fields: int
    pretrained: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def build(feature_map, embedding_dim, use_pretrain=True,
              required_feature_columns=(), not_required_feature_columns=(),
              force_dim=None, use_sharing=True):
        """force_dim overrides every field dim (the LR one-hot trick uses
        1). use_sharing=False gives every field its own rows even when
        share_embedding is set."""
        offsets = {}
        total_rows = 0
        fields = []
        token_cols, token_offsets, token_padding = [], [], []
        numeric_cols = []
        pretrained = {}
        slot = 0
        for name, spec in feature_map.feature_specs.items():
            if required_feature_columns and name not in required_feature_columns:
                continue
            if name in not_required_feature_columns:
                continue
            ftype = spec["type"]
            if ftype == "numeric":
                numeric_cols.append(spec["index"])
                fields.append(_FieldSpec(name, "numeric", (), (spec["index"],),
                                         -1, None, False, False, embedding_dim))
                continue
            owner = spec.get("share_embedding", name) \
                if (use_pretrain and use_sharing) else name
            feat_dim = force_dim if force_dim is not None \
                else spec.get("embedding_dim", embedding_dim)
            has_pretrained = use_pretrain and "pretrained_emb" in spec
            hook = has_pretrained and feat_dim != embedding_dim
            if hook:
                pretrained[name] = {"file": spec["pretrained_emb"],
                                    "offset": None, "side": True,
                                    "rows": spec["vocab_size"],
                                    "feat_dim": feat_dim,
                                    "freeze": spec.get("freeze_emb", True)}
                base = -1
            else:
                if owner not in offsets:
                    offsets[owner] = total_rows
                    total_rows += feature_map.feature_specs[owner]["vocab_size"]
                base = offsets[owner]
                if has_pretrained:
                    pretrained[name] = {
                        "file": spec["pretrained_emb"], "offset": base,
                        "side": False,
                        "rows": feature_map.feature_specs[owner]["vocab_size"],
                        "freeze": spec.get("freeze_emb", True)}
            if ftype == "categorical":
                pad = spec.get("padding_idx", -1)
                if pad is None:
                    pad = -1
                kind = "side_token" if hook else "token"
                fields.append(_FieldSpec(name, kind, (slot,) if not hook else (),
                                         (spec["index"],),
                                         pad, None, has_pretrained and
                                         spec.get("freeze_emb", True), hook, feat_dim))
                if not hook:
                    token_cols.append(spec["index"])
                    token_offsets.append(base)
                    token_padding.append(pad)
                    slot += 1
            elif ftype == "sequence":
                pad = spec["vocab_size"] - 1
                idxs = tuple(spec["index"])
                kind = "side_seq" if hook else "seq"
                slots = tuple(range(slot, slot + len(idxs))) if not hook else ()
                fields.append(_FieldSpec(name, kind, slots, idxs, pad,
                                         spec.get("encoder", "MaskedAveragePooling"),
                                         has_pretrained and spec.get("freeze_emb", True),
                                         hook, feat_dim))
                if not hook:
                    token_cols.extend(idxs)
                    token_offsets.extend([base] * len(idxs))
                    token_padding.extend([pad] * len(idxs))
                    slot += len(idxs)
            else:
                raise NotImplementedError("feature type={}".format(ftype))
        return EmbeddingSpec(fields=fields, total_rows=total_rows,
                             token_cols=np.asarray(token_cols, np.int64),
                             token_offsets=np.asarray(token_offsets, np.int64),
                             token_padding=np.asarray(token_padding, np.int64),
                             numeric_cols=np.asarray(numeric_cols, np.int64),
                             num_fields=len(fields),
                             pretrained=pretrained)


def load_pretrained(data_dir, fname, name):
    """The float32 rows of dataset ``name`` in the h5 file ``fname``
    under ``data_dir``. h5py is imported here, not with the module: the
    GPU machine has none, and only feature maps with pretrained fields
    need it."""
    import h5py
    with h5py.File(os.path.join(data_dir or ".", fname), "r") as hf:
        return torch.from_numpy(np.asarray(hf[name][:], dtype=np.float32))


def init_table(spec, embedding_dim, generator, std=1.e-4, data_dir=None):
    """The packed [total_rows, d] table: N(0, std) rows, the padding
    rows zero, the pretrained rows loaded."""
    table = embedding_init(generator, (spec.total_rows, embedding_dim), std=std)
    pad_rows = spec.token_offsets + spec.token_padding
    pad_rows = np.unique(pad_rows[spec.token_padding >= 0])
    table[torch.from_numpy(pad_rows)] = 0.0
    for name, info in spec.pretrained.items():
        if not info["side"]:
            table[info["offset"]: info["offset"] + info["rows"]] = \
                load_pretrained(data_dir, info["file"], name)
    return table


def _pool(vecs, mask, encoder):
    """Pool a sequence field's [..., max_len, d] vectors; ``mask``
    [..., max_len] marks its non-padding tokens."""
    if encoder in (None, "none", "null"):
        return vecs
    if encoder == "MaskedSumPooling":
        return vecs.sum(dim=-2)
    if encoder == "MaskedAveragePooling":
        cnt = mask.sum(dim=-1, keepdim=True).to(vecs.dtype)
        return vecs.sum(dim=-2) / (cnt + 1e-16)
    raise RuntimeError("sequence encoder={} is not supported.".format(encoder))


class RowShardedLookup(torch.autograd.Function):
    """``apply(table, rows, lo, group)``: ``table[rows]`` (global ids of any
    shape) for a table row-sharded over the process ``group``, whose rows
    [lo, lo + len(table)) are this rank's. Forward gathers the rows in range, zeros the rest and sums
    over ``group`` (each id lies in exactly one rank's range, so the sum
    adds one vector to zeros, exactly). Every rank of the group holds the
    same ``rows`` and gets the same gradient of the output, so backward
    is this rank's rows only, with no collective. A step graph captures
    it (engine/step_graph.py): its shapes follow ``rows`` and the
    table's, never the ids' values, and nothing waits on the host."""

    @staticmethod
    def forward(ctx, table, rows, lo, group):
        local = rows - lo
        hit = (local >= 0) & (local < table.shape[0])
        local = torch.where(hit, local, torch.zeros_like(local))
        if table.shape[0]:
            out = table[local] * hit[..., None].to(table.dtype)
        else:
            out = table.new_zeros(rows.shape + table.shape[1:])
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(local, hit)
        ctx.num_rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        local, hit = ctx.saved_tensors
        grad = grad * hit[..., None].to(grad.dtype)
        # the unsharded lookup's backward, so that a one-rank mesh gives
        # the unsharded gradient bit for bit
        return table_grad(grad, local, ctx.num_rows), None, None, None


class PackedEmbedding(nn.Module):
    """X [..., input_length] (and, with numeric fields, X_numeric, the
    same columns as float values) -> feature embeddings [..., F, d]."""

    def __init__(self, spec, embedding_dim, generator=None, init_std=1.e-4,
                 data_dir=None):
        super().__init__()
        self.spec = spec
        self.table = nn.Parameter(init_table(spec, embedding_dim, generator, init_std,
                                             data_dir))
        if spec.numeric_cols.size:
            self.numeric_weights = nn.Parameter(
                xavier_normal(generator, (len(spec.numeric_cols), embedding_dim)))
        for f in spec.fields:
            if f.hook:
                self.register_parameter("side_" + f.name, nn.Parameter(
                    load_pretrained(data_dir, spec.pretrained[f.name]["file"], f.name)))
                hook = nn.Linear(f.table_dim, embedding_dim, bias=False)
                with torch.no_grad():
                    hook.weight.copy_(xavier_normal(generator,
                                                    (embedding_dim, f.table_dim)))
                self.add_module("hook_" + f.name, hook)
        for name in ("token_cols", "token_offsets", "token_padding"):
            self.register_buffer(name, torch.from_numpy(getattr(spec, name)),
                                 persistent=False)
        self.row_shard = None

    def shard_rows(self, lo, hi, group):
        """Keep rows [lo, hi) of the packed table, the others living on
        the other ranks of the process ``group``."""
        self.table = nn.Parameter(self.table.detach()[lo:hi].clone())
        self.row_shard = (lo, group)

    def forward(self, X, X_numeric=None):
        ids_local = X[..., self.token_cols]                             # [..., T]
        rows = ids_local + self.token_offsets
        if self.row_shard is None:
            emb = lookup(self.table, rows)                              # [..., T, d]
        else:
            emb = RowShardedLookup.apply(self.table, rows, *self.row_shard)
        pad = self.token_padding
        mask = (ids_local != pad) | (pad < 0)
        emb = emb * mask[..., None].to(emb.dtype)
        outputs = []
        for f in self.spec.fields:
            if f.kind == "numeric":
                pos = int(np.flatnonzero(self.spec.numeric_cols == f.x_cols[0])[0])
                outputs.append(X_numeric[..., f.x_cols[0], None]
                               * self.numeric_weights[pos])
                continue
            if f.hook:
                ids = X[..., f.x_cols[0]] if f.kind == "side_token" \
                    else X[..., list(f.x_cols)]
                vecs = lookup(getattr(self, "side_" + f.name), ids)
                keep = ids != f.padding_idx
                if f.padding_idx >= 0:
                    vecs = vecs * keep[..., None].to(vecs.dtype)
                if f.frozen:
                    vecs = vecs.detach()
                if f.kind == "side_seq":
                    vecs = _pool(vecs, keep, f.encoder)
                outputs.append(getattr(self, "hook_" + f.name)(vecs))
                continue
            span = slice(f.token_slots[0], f.token_slots[-1] + 1)
            vecs = emb[..., span, :]
            if f.frozen:
                vecs = vecs.detach()
            outputs.append(vecs[..., 0, :] if f.kind == "token"
                           else _pool(vecs, mask[..., span], f.encoder))
        return torch.stack(outputs, dim=-2)


class LabelEmbedding(nn.Module):
    """3-entry label table: 0/1 = labels, 2 = [MASK] for the target.
    torch's plain nn.Embedding default init is N(0, 1)."""

    def __init__(self, embedding_dim, generator=None):
        super().__init__()
        self.table = nn.Parameter(torch.randn((3, embedding_dim),
                                              generator=generator))

    def forward(self, labels):
        return lookup(self.table, labels)


class MergedEmbeddingLayer(nn.Module):
    """One ``table`` over the concatenated vocabularies of every field,
    Xavier-uniform (fan_avg: U(-a, a), a = sqrt(6 / (rows + d))). It
    takes globally offset ids
    (``data.graph.PETGraphProcessor.convert_indices``)."""

    def __init__(self, feature_map, embedding_dim, generator=None):
        super().__init__()
        rows = sum(spec["vocab_size"] for spec in feature_map.feature_specs.values())
        bound = math.sqrt(6.0 / (rows + embedding_dim))
        self.table = nn.Parameter(
            (2 * torch.rand((rows, embedding_dim), generator=generator) - 1) * bound)

    def forward(self, X):
        # F.embedding's CUDA backward splits the runs of a repeated id;
        # indexing's adds them one by one (a frequent id recurs ~B times)
        return F.embedding(X, self.table)
