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
  average over the non-padding tokens.

Not ported yet: numeric fields and pretrained (or side) tables; a
feature map that has them raises at construction.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .initializers import embedding_init


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


class PackedEmbedding(nn.Module):
    """X [..., input_length] -> feature embeddings [..., F, d]."""

    def __init__(self, spec, embedding_dim, generator=None, init_std=1.e-4):
        super().__init__()
        if spec.numeric_cols.size or spec.pretrained:
            raise NotImplementedError(
                "numeric fields and pretrained tables are not ported yet "
                "(ROADMAP.md, Queue 1 item 2)")
        self.spec = spec
        table = embedding_init(generator, (spec.total_rows, embedding_dim),
                               std=init_std)
        pad_rows = spec.token_offsets + spec.token_padding
        pad_rows = np.unique(pad_rows[spec.token_padding >= 0])
        table[torch.from_numpy(pad_rows)] = 0.0
        self.table = nn.Parameter(table)
        for name in ("token_cols", "token_offsets", "token_padding"):
            self.register_buffer(name, torch.from_numpy(getattr(spec, name)),
                                 persistent=False)

    def forward(self, X):
        ids_local = X[..., self.token_cols]                             # [..., T]
        emb = self.table[ids_local + self.token_offsets]                # [..., T, d]
        pad = self.token_padding
        mask = (ids_local != pad) | (pad < 0)
        emb = emb * mask[..., None].to(emb.dtype)
        outputs = []
        for f in self.spec.fields:
            vecs = emb[..., f.token_slots[0]: f.token_slots[-1] + 1, :]
            if f.kind == "token":
                outputs.append(vecs[..., 0, :])
            elif f.encoder in (None, "none", "null"):
                outputs.append(vecs)
            elif f.encoder == "MaskedSumPooling":
                outputs.append(vecs.sum(dim=-2))
            elif f.encoder == "MaskedAveragePooling":
                m = mask[..., f.token_slots[0]: f.token_slots[-1] + 1]
                cnt = m.sum(dim=-1, keepdim=True).to(emb.dtype)
                outputs.append(vecs.sum(dim=-2) / (cnt + 1e-16))
            else:
                raise RuntimeError("sequence encoder={} is not supported."
                                   .format(f.encoder))
        return torch.stack(outputs, dim=-2)


class LabelEmbedding(nn.Module):
    """3-entry label table: 0/1 = labels, 2 = [MASK] for the target.
    torch's plain nn.Embedding default init is N(0, 1)."""

    def __init__(self, embedding_dim, generator=None):
        super().__init__()
        self.table = nn.Parameter(torch.randn((3, embedding_dim),
                                              generator=generator))

    def forward(self, labels):
        return self.table[labels]
