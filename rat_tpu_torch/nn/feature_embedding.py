"""FuxiCTR-v2-style feature embedding API (port of
rat_tpu.nn.feature_embedding): a per-feature embedding dict with
call-time ``feature_source`` / ``feature_type`` filters, per-field
``embedding_dim`` overrides (concatenated with ``dynamic_emb_dim``),
declarative per-field ``feature_encoder`` chains, required /
not-required column filters, the ``use_pretrain`` / ``use_sharing``
knobs and the dim-1 LR fallback.

Fields are grouped by their embedding dim; each group has one packed
table ``table_d{dim}`` (and ``numeric_weights_d{dim}``) and one gather,
and the dict is sliced out of the group gathers.

``feature_encoder`` strings are parsed into a closed registry
(MaskedAveragePooling, MaskedSumPooling, KMaxPooling, Linear) by a walk
of the expression's syntax tree that takes only literal arguments; the
config text is never executed. A Linear encoder ``enc_{field}_{i}``
infers its input width from the chain before it.

Pretrained tables must match the field's embedding dim: each group is
built at its fields' own dim, so no field gets the side table and
projection hook of :class:`PackedEmbedding`.
"""

import ast
import re
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention_lib import k_max_pooling
from .embedding import EmbeddingSpec, init_table
from .initializers import xavier_normal
from .layers import linear

_ENCODERS = ("MaskedAveragePooling", "MaskedSumPooling", "KMaxPooling", "Linear")


def parse_feature_encoder(expr):
    """One encoder spec string -> (name, args, kwargs).

    Accepts the reference config forms (``layers.MaskedAveragePooling()``,
    ``nn.Linear(40, 10, bias=False)``, ``layers.KMaxPooling(2, dim=1)``)
    with literal arguments and a name of the registry only; anything
    else raises ValueError.
    """
    try:
        node = ast.parse(expr.strip(), mode="eval").body
    except SyntaxError as e:
        raise ValueError("feature_encoder={} is not supported.".format(expr)) from e
    if not isinstance(node, ast.Call):
        raise ValueError("feature_encoder={} is not supported.".format(expr))
    func = node.func
    name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
    if name not in _ENCODERS:
        raise ValueError("feature_encoder={} is not supported.".format(expr))
    try:
        args = tuple(ast.literal_eval(a) for a in node.args)
        kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    except (ValueError, SyntaxError) as e:
        raise ValueError("feature_encoder={} must use literal arguments"
                         .format(expr)) from e
    return (name, args, kwargs)


def _parse_encoders(spec):
    """A feature_encoder spec (a string or a list of strings) -> the
    parsed encoders, applied in order."""
    if spec is None:
        return ()
    if isinstance(spec, (list, tuple)):
        return tuple(parse_feature_encoder(s) for s in spec)
    return (parse_feature_encoder(spec),)


def _init_std(embedding_initializer):
    """The std of a ``partial(nn.init.normal_, std=S)`` string or a float
    (only the normal family is meaningful)."""
    if embedding_initializer is None:
        return 1e-4
    if isinstance(embedding_initializer, (int, float)):
        return float(embedding_initializer)
    m = re.search(r"std\s*=\s*([0-9.eE+-]+)", str(embedding_initializer))
    if m is None:
        raise ValueError("embedding_initializer={} is not supported "
                         "(use partial(nn.init.normal_, std=S) or a float std)"
                         .format(embedding_initializer))
    return float(m.group(1))


def _as_list(value):
    return list(value) if isinstance(value, (list, tuple)) else [value]


def _selected(fspec, feature_source, feature_type):
    return (not feature_source or fspec.get("source") in feature_source) and \
        (not feature_type or fspec["type"] in feature_type)


class FeatureEmbeddingDict(nn.Module):
    """X [..., input_length] -> OrderedDict{feature: [..., d_f] (or
    [..., L, d_f] for a sequence field without a pooling encoder)}."""

    def __init__(self, feature_map, embedding_dim,
                 embedding_initializer="partial(nn.init.normal_, std=1e-4)",
                 required_feature_columns=(), not_required_feature_columns=(),
                 use_pretrain=True, use_sharing=True, data_dir=None, generator=None):
        super().__init__()
        self.feature_map = feature_map
        # the dim-1 LR fallback: every field 1 wide, sequences sum-pooled
        lr_mode = not (use_pretrain and use_sharing) and embedding_dim == 1
        entries = OrderedDict()
        for name, spec in feature_map.feature_specs.items():
            if spec["type"] == "meta":
                continue
            if required_feature_columns and name not in required_feature_columns:
                continue
            if name in (not_required_feature_columns or ()):
                continue
            if lr_mode:
                dim = 1
                encoders = (("MaskedSumPooling", (), {}),) \
                    if spec["type"] == "sequence" else ()
            else:
                dim = spec.get("embedding_dim", embedding_dim)
                encoders = _parse_encoders(spec.get("feature_encoder"))
            entries[name] = (dim, encoders)
        self.encoders = {name: enc for name, (_, enc) in entries.items()}
        std = _init_std(embedding_initializer)

        groups = OrderedDict()
        for name, (dim, _) in entries.items():
            groups.setdefault(dim, []).append(name)
        self.specs = OrderedDict()
        for dim, names in groups.items():
            spec = EmbeddingSpec.build(feature_map, dim, use_pretrain=use_pretrain,
                                       required_feature_columns=tuple(names),
                                       use_sharing=use_sharing,
                                       force_dim=1 if lr_mode else None)
            self.specs[dim] = spec
            self.register_parameter("table_d{}".format(dim), nn.Parameter(
                init_table(spec, dim, generator, std, data_dir)))
            if spec.numeric_cols.size:
                self.register_parameter("numeric_weights_d{}".format(dim), nn.Parameter(
                    xavier_normal(generator, (len(spec.numeric_cols), dim))))
            for key in ("token_cols", "token_offsets", "token_padding"):
                self.register_buffer("{}_d{}".format(key, dim),
                                     torch.from_numpy(getattr(spec, key)), persistent=False)
            for f in spec.fields:
                width = dim
                for i, (enc, args, kwargs) in enumerate(self.encoders[f.name]):
                    if enc != "Linear":
                        continue
                    # torch nn.Linear(in, out, bias=...): in_features is inferred
                    out = kwargs.get("out_features", args[1] if len(args) > 1 else args[0])
                    bias = kwargs.get("bias", args[2] if len(args) > 2 else True)
                    self.add_module("enc_{}_{}".format(f.name, i),
                                    linear(width, out, generator, bias=bias))
                    width = out

    def _apply_encoder(self, emb, enc, layer_name):
        name, args, kwargs = enc
        if name == "MaskedSumPooling":
            return emb.sum(dim=-2)
        if name == "MaskedAveragePooling":
            # the count of non-zero entries per dim, as the reference
            # counts them; padding rows embed to exact zeros
            cnt = (emb != 0).sum(dim=-2).to(emb.dtype)
            return emb.sum(dim=-2) / (cnt + 1e-16)
        if name == "KMaxPooling":
            k = kwargs.get("k", args[0] if args else 1)
            dim = kwargs.get("dim", args[1] if len(args) > 1 else -2)
            if dim >= 0:
                # a config writes the axis against a [B, L, D] input; the
                # span may have more leading axes ([B, 1+K, L, D] on the
                # RAT grid), so a non-negative axis counts from the right
                dim -= 3
            return k_max_pooling(emb, k, dim)
        return getattr(self, layer_name)(emb)

    def forward(self, X_tokens, X_numeric=None, feature_source=(), feature_type=()):
        out = OrderedDict()
        for dim, spec in self.specs.items():
            cols, offsets, pad = (getattr(self, "{}_d{}".format(key, dim)) for key in
                                  ("token_cols", "token_offsets", "token_padding"))
            ids_local = X_tokens[..., cols]
            # F.embedding's CUDA backward splits the runs of a repeated id
            emb = F.embedding(ids_local + offsets, getattr(self, "table_d{}".format(dim)))
            mask = (ids_local != pad) | (pad < 0)
            emb = emb * mask[..., None].to(emb.dtype)
            for f in spec.fields:
                if f.kind == "numeric":
                    pos = int(np.flatnonzero(spec.numeric_cols == f.x_cols[0])[0])
                    vec = X_numeric[..., spec.numeric_cols[pos], None] \
                        * getattr(self, "numeric_weights_d{}".format(dim))[pos]
                elif f.kind == "token":
                    vec = emb[..., f.token_slots[0], :]
                else:       # the sequence's span; its encoders pool or map it
                    vec = emb[..., f.token_slots[0]: f.token_slots[-1] + 1, :]
                if f.frozen:
                    vec = vec.detach()
                for i, enc in enumerate(self.encoders[f.name]):
                    vec = self._apply_encoder(vec, enc, "enc_{}_{}".format(f.name, i))
                out[f.name] = vec
        # the filters act on the output only, so the parameters do not
        # depend on them
        feature_source, feature_type = _as_list(feature_source), _as_list(feature_type)
        return OrderedDict((name, out[name]) for name, fspec in
                           self.feature_map.feature_specs.items()
                           if name in out and _selected(fspec, feature_source, feature_type))

    def dict2tensor(self, embedding_dict, feature_source=(), feature_type=(),
                    dynamic_emb_dim=False):
        """The dict -> a [..., F, d] stack, or with ``dynamic_emb_dim`` a
        [..., sum(d_f)] concatenation."""
        feature_source, feature_type = _as_list(feature_source), _as_list(feature_type)
        embs = [embedding_dict[name] for name, fspec in self.feature_map.feature_specs.items()
                if _selected(fspec, feature_source, feature_type) and name in embedding_dict]
        return torch.cat(embs, dim=-1) if dynamic_emb_dim else torch.stack(embs, dim=-2)


class FeatureEmbedding(nn.Module):
    """The tensor view: ``embedding_layer`` (a FeatureEmbeddingDict), then
    a stack or a concatenation."""

    def __init__(self, feature_map, embedding_dim,
                 embedding_initializer="partial(nn.init.normal_, std=1e-4)",
                 required_feature_columns=(), not_required_feature_columns=(),
                 use_pretrain=True, use_sharing=True, data_dir=None, generator=None):
        super().__init__()
        self.embedding_layer = FeatureEmbeddingDict(
            feature_map, embedding_dim, embedding_initializer=embedding_initializer,
            required_feature_columns=required_feature_columns,
            not_required_feature_columns=not_required_feature_columns,
            use_pretrain=use_pretrain, use_sharing=use_sharing, data_dir=data_dir,
            generator=generator)

    def forward(self, X_tokens, X_numeric=None, feature_source=(), feature_type=(),
                dynamic_emb_dim=False):
        emb_dict = self.embedding_layer(X_tokens, X_numeric, feature_source=feature_source,
                                        feature_type=feature_type)
        return self.embedding_layer.dict2tensor(emb_dict, feature_source=feature_source,
                                                feature_type=feature_type,
                                                dynamic_emb_dim=dynamic_emb_dim)
