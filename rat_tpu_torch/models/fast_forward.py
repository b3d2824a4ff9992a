"""Fused fast-forward path for RAT_m2 (port of
rat_tpu.models.fast_forward).

The RATModel forward with each encoder block run through kernel K1
(ops/cross_intra_block.py::cross_intra_block) on the module's own
parameters: on a CUDA device every block is one kernel launch, on the
CPU the block's plain version. It is differentiable: the block's
backward is autograd of its plain version, so the Trainer trains and
scores through here with ``use_pallas: true`` (the JAX package's switch
for its fused path). Callers that only score wrap it in
``torch.no_grad()``.

Unlike the JAX kernel, K1 takes any batch size, so the batch is not
padded to a block multiple, and without ``project_out`` (heads == 1 and
dim_head == d) the projection is skipped instead of fed zeros.
"""

from ..ops.cross_intra_block import cross_intra_block


def _block_params(block):
    """The 14 K1 weights of one CrossIntraEncoderBlock, in nn.Linear
    layout, as views of the module's parameters."""
    intra, cross = block.intra_attention, block.cross_attention

    def out(attn):
        if attn.to_out is None:
            return None, None
        return attn.to_out.weight, attn.to_out.bias

    w_out1, b_out1 = out(intra.attn)
    w_out2, b_out2 = out(cross.attn)
    return {
        "ln1_scale": intra.norm.weight, "ln1_bias": intra.norm.bias,
        "w_qkv1": intra.attn.to_qkv.weight, "w_out1": w_out1, "b_out1": b_out1,
        "ln2_scale": cross.norm.weight, "ln2_bias": cross.norm.bias,
        "w_qkv2": cross.attn.to_qkv.weight, "w_out2": w_out2, "b_out2": b_out2,
        "ff_w1": block.mlp.fc1.weight, "ff_b1": block.mlp.fc1.bias,
        "ff_w2": block.mlp.fc2.weight, "ff_b2": block.mlp.fc2.bias,
    }


def rat_m2_fast_forward(model, X, y, X_num=None):
    """model: a RATModel (default variant); X_num as in its forward.
    Returns {"y_pred", "y_true"} equal to ``model(X, y, X_num)`` within
    float tolerance when the model has no dropout and no BatchNorm in
    training (the kernel has neither; the Trainer's gate sends such
    models through the module path)."""
    if model.variant != "default":
        raise ValueError("the fused path runs RAT_m2 only")
    feature_emb, grid = model.grid(X, y, X_num)
    grid = grid.contiguous()
    project_out = not (model.num_heads == 1 and model.dim_head == model.embedding_dim)
    for block in model.encoder.blocks:
        grid = cross_intra_block(grid, _block_params(block), model.num_heads,
                                 model.dim_head, project_out=project_out)
    cls = grid[:, 0, 0]
    return {"y_pred": model.head(cls, feature_emb, X, X_num), "y_true": y[:, 0:1]}
