"""Carry RATModel weights from the JAX package's flax trees to this
package's state dict, for every variant.

The trees are given as nested dicts of numpy arrays (``jax.device_get``
of ``TrainState.params`` and, with BatchNorm, ``TrainState.batch_stats``).
Flax ``Dense`` kernels are [in, out] and become ``nn.Linear`` weights
[out, in]; LayerNorm and BatchNorm ``scale`` becomes ``weight``; the
BatchNorm statistics ``mean`` / ``var`` become the buffers
``running_mean`` / ``running_var``. Every embedding parameter keeps
``embedding_layer`` in its name (``embedding_layer.{table,
numeric_weights, side_*, hook_*}``, ``label_embedding_layer``,
``lr_layer.embedding_layer``), the key of the embedding regularizer. A
flax path without a rule raises.
"""

import re

import numpy as np
import torch

_ENC = r"encoder/CrossIntraEncoderBlock(?:PA)?_(\d+)"
_TF = r"encoder/(encoder|intra_transformer|cross_transformer)"

# (flax module path, torch module name, the leaves the module holds)
_RULES = (
    (r"", r"", r"query_proj_kernel|query_proj_bias"),
    (r"(embedding_layer|label_embedding_layer|lr_layer/embedding_layer)", r"\1",
     r"table|numeric_weights|side_\w+"),
    (r"embedding_layer/(hook_\w+)", r"embedding_layer.\1", r"kernel"),
    (r"fc", r"fc", r"kernel|bias"),
    (r"dnn/Dense_(\d+)", r"dnn.linears.\1", r"kernel|bias"),
    (r"dnn/TorchBatchNorm_(\d+)", r"dnn.norms.\1", r"scale|bias|mean|var"),
    # RAT_m2 and RAT_m3 blocks
    (_ENC + r"/(intra|cross)_attention/LayerNorm_0", r"encoder.blocks.\1.\2_attention.norm",
     r"scale|bias"),
    (r"encoder/CrossIntraEncoderBlock_(\d+)/(intra|cross)_attention/Attention_0/"
     r"(to_qkv|to_out)", r"encoder.blocks.\1.\2_attention.attn.\3", r"kernel|bias"),
    (_ENC + r"/mlp/Dense_0", r"encoder.blocks.\1.mlp.fc1", r"kernel|bias"),
    (_ENC + r"/mlp/Dense_1", r"encoder.blocks.\1.mlp.fc2", r"kernel|bias"),
    (r"encoder/CrossIntraEncoderBlockPA_(\d+)", r"encoder.blocks.\1", r"W_q"),
    (r"encoder/CrossIntraEncoderBlockPA_(\d+)/(intra|cross)_attention/(W_k|W_v|to_out)",
     r"encoder.blocks.\1.\2_attention.\3", r"kernel|bias"),
    # RAT_m0 and RAT_m1 transformers
    (_TF + r"/attn_(\d+)/LayerNorm_0", r"encoder.\1.attn_\2.norm", r"scale|bias"),
    (_TF + r"/attn_(\d+)/Attention_0/(to_qkv|to_out)", r"encoder.\1.attn_\2.attn.\3",
     r"kernel|bias"),
    (_TF + r"/ff_(\d+)/LayerNorm_0", r"encoder.\1.ff_\2.norm", r"scale|bias"),
    (_TF + r"/ff_(\d+)/FeedForward_0/Dense_0", r"encoder.\1.ff_\2.ff.fc1", r"kernel|bias"),
    (_TF + r"/ff_(\d+)/FeedForward_0/Dense_1", r"encoder.\1.ff_\2.ff.fc2", r"kernel|bias"),
    (_TF + r"/LayerNorm_0", r"encoder.\1.norm", r"scale|bias"),
)

# flax leaf -> (torch leaf, transpose?); other leaves keep their name
_LEAVES = {"kernel": ("weight", True), "scale": ("weight", False),
           "mean": ("running_mean", False), "var": ("running_var", False),
           "W_q": ("W_q", True)}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = prefix + str(key)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def torch_name(path):
    """(state-dict name, transpose?) of a flax parameter or batch-stats
    path; raises KeyError for a path without a rule."""
    # RAT_m0 / m1 encoders are unnamed in flax (JointEncoder_0,
    # CascadeEncoder_0); the port names every variant's "encoder"
    path = re.sub(r"^(?:JointEncoder|CascadeEncoder)_0/", "encoder/", path)
    module, _, leaf = path.rpartition("/")
    for pattern, template, leaves in _RULES:
        m = re.fullmatch(pattern, module)
        if m is None or re.fullmatch(leaves, leaf) is None:
            continue
        name, transpose = _LEAVES.get(leaf, (leaf, False))
        prefix = m.expand(template).replace("/", ".")
        return (prefix + "." if prefix else "") + name, transpose
    raise KeyError("no torch counterpart for flax parameter " + path)


def params_from_jax(params, batch_stats=None):
    """RATModel flax params (and batch stats) -> RATModel state dict."""
    state = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            name, transpose = torch_name(path)
            arr = np.array(value, dtype=np.float32)   # a writable copy
            state[name] = torch.from_numpy(np.ascontiguousarray(
                arr.T if transpose else arr))
    return state
