"""Carry RATModel weights from the JAX package's flax parameter tree to
this package's state dict.

The tree is given as nested dicts of numpy arrays (``jax.device_get``
of ``TrainState.params``). Flax ``Dense`` kernels are [in, out] and
become ``nn.Linear`` weights [out, in]; LayerNorm ``scale`` becomes
``weight``. Every table keeps ``embedding_layer`` in its name
(``embedding_layer``, ``label_embedding_layer``,
``lr_layer.embedding_layer``), the key of the embedding regularizer.
"""

import re

import numpy as np
import torch

# (flax path regex, torch name template, transpose?)
_RULES = (
    (r"encoder/CrossIntraEncoderBlock_(\d+)/(intra|cross)_attention/LayerNorm_0/scale",
     r"encoder.blocks.\1.\2_attention.norm.weight", False),
    (r"encoder/CrossIntraEncoderBlock_(\d+)/(intra|cross)_attention/LayerNorm_0/bias",
     r"encoder.blocks.\1.\2_attention.norm.bias", False),
    (r"encoder/CrossIntraEncoderBlock_(\d+)/(intra|cross)_attention/Attention_0/(to_qkv|to_out)/kernel",
     r"encoder.blocks.\1.\2_attention.attn.\3.weight", True),
    (r"encoder/CrossIntraEncoderBlock_(\d+)/(intra|cross)_attention/Attention_0/to_out/bias",
     r"encoder.blocks.\1.\2_attention.attn.to_out.bias", False),
    (r"encoder/CrossIntraEncoderBlock_(\d+)/mlp/Dense_0/(kernel|bias)",
     r"encoder.blocks.\1.mlp.fc1.\2", None),
    (r"encoder/CrossIntraEncoderBlock_(\d+)/mlp/Dense_1/(kernel|bias)",
     r"encoder.blocks.\1.mlp.fc2.\2", None),
    (r"dnn/Dense_(\d+)/(kernel|bias)", r"dnn.linears.\1.\2", None),
    (r"fc/(kernel|bias)", r"fc.\1", None),
    (r"(embedding_layer|label_embedding_layer|lr_layer/embedding_layer)/table",
     r"\1.table", False),
    (r"(query_proj_kernel|query_proj_bias)", r"\1", False),
)


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = prefix + str(key)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def params_from_jax(tree):
    """RATModel (default variant) flax params -> RATModel state dict."""
    state = {}
    for path, value in _flatten(tree):
        for pattern, template, transpose in _RULES:
            m = re.fullmatch(pattern, path)
            if m is None:
                continue
            name = m.expand(template).replace("/", ".")
            if transpose is None:       # Dense: kernel transposes, bias not
                transpose = name.endswith(".kernel")
                name = re.sub(r"\.kernel$", ".weight", name)
            arr = np.array(value, dtype=np.float32)   # a writable copy
            state[name] = torch.from_numpy(np.ascontiguousarray(
                arr.T if transpose else arr))
            break
        else:
            raise KeyError("no torch counterpart for flax parameter " + path)
    return state
