"""The four RAT variants over the shared (1+K) x (F+1) token grid (port
of rat_tpu.models.rat).

Input construction: embed the target row and its K retrieved neighbor
rows with the packed field tables; embed LABELS with a 3-entry table —
neighbors use their true 0/1 label, the target the mask id 2 — and
prepend the label embedding as token 0 of every sample. The grid is
multiplied by the neighbor mask (``neighbor_padding="mask"``), then
goes through the embedding dropout.

Head: ``y_pred = fc(CLS) + MLP(target_emb.flatten()) [+ LR(X_target)]``
followed by sigmoid; CLS is grid position [0, 0] after the encoder
(position 0 of RAT_m1's [B, 1+K, d] output). The wide tower sees the
target row only.

Variants: RAT_m0 = JointEncoder, RAT_m1 = CascadeEncoder, RAT_m2 =
CrossIntraEncoder (the default), RAT_m3 = CrossIntraEncoderPA. Dropout
and BatchNorm follow ``module.training``, as flax's ``train`` flag.
"""

import torch
from torch import nn

from ..nn.embedding import EmbeddingSpec, LabelEmbedding, PackedEmbedding
from ..nn.encoders import (CascadeEncoder, CrossIntraEncoder, CrossIntraEncoderPA,
                           JointEncoder)
from ..nn.initializers import xavier_normal
from ..nn.layers import Dropout, LRLayer, MLPLayer, linear

VARIANTS = {"RAT_m0": "jm", "RAT_m1": "ce", "RAT_m2": "default", "RAT_m3": "pa"}


class RATModel(nn.Module):
    def __init__(self, embedding_spec, lr_spec, num_fields, embedding_dim=10,
                 dnn_hidden_units=(64, 64, 64), dnn_activations="relu",
                 num_heads=1, dim_head=10, depth=4, scale_dim=4,
                 dropout=0., emb_dropout=0., net_dropout=0., batch_norm=False,
                 use_wide=False, variant="default", data_dir=None, generator=None):
        super().__init__()
        if variant not in VARIANTS.values():
            raise NotImplementedError("variant={}".format(variant))
        self.variant = variant
        self.embedding_spec = embedding_spec
        self.lr_spec = lr_spec
        self.num_fields = num_fields
        self.embedding_dim = d = embedding_dim
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_activations = dnn_activations
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.depth = depth
        self.scale_dim = scale_dim
        self.dropout = dropout
        self.emb_dropout = emb_dropout
        self.net_dropout = net_dropout
        self.batch_norm = batch_norm
        self.use_wide = use_wide
        F = num_fields

        self.embedding_layer = PackedEmbedding(embedding_spec, d, generator=generator,
                                               data_dir=data_dir)
        self.label_embedding_layer = LabelEmbedding(d, generator=generator)
        # dead params kept for parameter-count/checkpoint parity with the
        # reference's unused query_proj, in the flax [in, out] layout
        self.query_proj_kernel = nn.Parameter(
            xavier_normal(generator, (d * F, d * F)))
        self.query_proj_bias = nn.Parameter(torch.zeros(d * F))
        self.emb_drop = Dropout(emb_dropout)
        hidden = d * scale_dim
        if variant == "default":
            self.encoder = CrossIntraEncoder(d, num_heads, dim_head, depth, hidden,
                                             dropout, generator=generator)
        elif variant == "pa":
            self.encoder = CrossIntraEncoderPA(d, num_heads, dim_head, depth, hidden,
                                               dropout, generator=generator)
        elif variant == "jm":
            self.encoder = JointEncoder(d, depth, num_heads, dim_head, hidden,
                                        dropout, generator=generator)
        else:
            self.encoder = CascadeEncoder(d, depth, num_heads, dim_head, hidden,
                                          dropout, generator=generator)
        self.fc = linear(d, 1, generator)
        self.dnn = MLPLayer(F * d, 1, self.dnn_hidden_units, dnn_activations,
                            dropout_rates=net_dropout, batch_norm=batch_norm,
                            generator=generator) if self.dnn_hidden_units else None
        self.lr_layer = LRLayer(lr_spec, generator=generator) if use_wide else None

    def grid(self, X, y, X_num=None):
        """(feature_emb [B, T, F, d], grid [B, T, F+1, d])."""
        B = X.shape[0]
        feature_emb = self.embedding_layer(X, X_num)
        label_ids = torch.cat(
            [torch.full((B, 1), 2, dtype=torch.int64, device=X.device),
             y[:, 1:].to(torch.int64)], dim=1)                   # [B, T]
        label_emb = self.label_embedding_layer(label_ids)[:, :, None, :]
        return feature_emb, torch.cat([label_emb, feature_emb], dim=2)

    def head(self, cls, feature_emb, X, X_num=None):
        """fc(CLS) + DNN(target embedding) + LR(target row), sigmoid."""
        B = X.shape[0]
        y_pred = self.fc(cls)
        if self.dnn is not None:
            y_pred = y_pred + self.dnn(feature_emb[:, 0].reshape(B, -1))
        if self.lr_layer is not None:
            # the reference slices the TARGET row before the wide tower
            y_pred = y_pred + self.lr_layer(
                X[:, 0:1], None if X_num is None else X_num[:, 0:1])
        return torch.sigmoid(y_pred)

    def forward(self, X, y, X_num=None, nbr_mask=None):
        """X: [B, 1+K, L] int token ids, y: [B, 1+K] float labels, X_num:
        [B, 1+K, L] float values of the numeric columns (needed only
        with numeric fields), nbr_mask: optional [B, 1+K] float validity
        mask (the corrected ``neighbor_padding="mask"`` mode: dropped
        neighbors are zeroed instead of gathering the pool's last row).
        Returns {"y_pred": [B, 1] post-sigmoid, "y_true": [B, 1]}."""
        feature_emb, grid = self.grid(X, y, X_num)
        if nbr_mask is not None:
            grid = grid * nbr_mask[:, :, None, None]
        out = self.encoder(self.emb_drop(grid))
        cls = out[:, 0] if self.variant == "ce" else out[:, 0, 0]
        return {"y_pred": self.head(cls, feature_emb, X, X_num), "y_true": y[:, 0:1]}


def build_model(feature_map, params):
    """A RATModel from a merged experiment config dict, its weights drawn
    from a ``torch.Generator`` seeded with ``params["seed"]``. The
    ``encoder_impl`` key (a TPU layout choice) is accepted and ignored."""
    model_name = params["model"]
    if model_name not in VARIANTS:
        raise NotImplementedError("model={} is not supported.".format(model_name))
    embedding_dim = params.get("embedding_dim", 10)
    generator = torch.Generator().manual_seed(int(params.get("seed", 2021)))
    spec = EmbeddingSpec.build(feature_map, embedding_dim)
    lr_spec = EmbeddingSpec.build(feature_map, 1, use_pretrain=False,
                                  force_dim=1) if params.get("use_wide") else None
    return RATModel(
        variant=VARIANTS[model_name],
        embedding_spec=spec,
        lr_spec=lr_spec,
        num_fields=feature_map.num_fields,
        embedding_dim=embedding_dim,
        dnn_hidden_units=tuple(params.get("dnn_hidden_units", [64, 64, 64]) or ()),
        dnn_activations=params.get("dnn_activations", "relu"),
        num_heads=params.get("num_heads", 1),
        dim_head=params.get("dim_head", 10),
        depth=params.get("depth", 4),
        scale_dim=params.get("scale_dim", 4),
        dropout=params.get("dropout", 0.),
        emb_dropout=params.get("emb_dropout", 0.),
        net_dropout=params.get("net_dropout", 0.),
        batch_norm=params.get("batch_norm", False),
        use_wide=params.get("use_wide", False),
        data_dir=feature_map.data_dir,
        generator=generator,
    )
