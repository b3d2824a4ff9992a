"""The port's APG layers and MLP block (rat_tpu_torch.nn.deep), the
options MLPLayer gained for them and PreNorm, against the JAX package's on seeded
inputs on the CPU (B=8, widths <= 12): APGLinear plain, generated,
low-rank and over-parameterized; APGMLPLayer in every condition mode,
moe under every aggregation, attention with condition_lens that mask
experts (a row with none); MLPBlock with BatchNorm or LayerNorm before
or after the activation. Outputs within rtol 1e-5 / atol 1e-6, parameter
gradients within rtol 1e-4 / atol 1e-5 (each atol at the scale of the
largest value where it is above 1), BatchNorm's running statistics
compared after train-mode calls."""

import numpy as np
import pytest

from rat_tpu.nn import deep as jd
from rat_tpu.nn import layers as jl
from rat_tpu_torch.nn import deep as td
from rat_tpu_torch.nn import layers as tl
from torch_layer_parity import compare, one_thread  # noqa: F401

B = 8


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(output_dim=None, hidden_units=(6, 5), output_activation="tanh"),
    dict(output_dim=3, hidden_units=(6, 5), hidden_activations=["relu", "gelu"],
         use_bias=False),
    dict(output_dim=2, hidden_units=(4,), hidden_activations="sigmoid",
         output_activation="sigmoid", batch_norm=True)], ids=["no_output", "acts", "bn"])
def test_mlp_layer_options(kw):
    """output_dim=None (no output Linear), output_activation, one
    activation per layer and use_bias, which RATModel leaves at their
    defaults."""
    compare(jl.MLPLayer(input_dim=7, **kw), tl.MLPLayer(7, **kw), [_x(0, B, 7)],
            train=True, grads=True)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_bias=False)], ids=["bias", "no_bias"])
def test_apg_linear_plain(kw):
    compare(jd.APGLinear(6, 4, **kw), td.APGLinear(6, 4, **kw), [_x(1, B, 6)], grads=True)


@pytest.mark.parametrize("rank,over", [(None, None), (3, None), (3, 5)],
                         ids=["full", "low_rank", "overparam"])
def test_apg_linear_generated(rank, over):
    gen = 9 if rank else 24
    compare(jd.APGLinear(6, 4, is_weight_generated=True, decompose_rank=rank,
                         overparam_dim=over),
            td.APGLinear(6, 4, is_weight_generated=True, decompose_rank=rank,
                         overparam_dim=over),
            [_x(2, B, 6), _x(3, B, gen)], grads=True)


META = {"hidden_units": [5], "hidden_activations": "relu"}


def _apg(mode, **kw):
    base = dict(input_dim=6, output_dim=1, hidden_units=(5, 4), condition_mode=mode,
                decompose_ranks=kw.pop("decompose_ranks", 2), **kw)
    return jd.APGMLPLayer(**base), td.APGMLPLayer(**base)


def test_apg_mlp_none_mode_with_batch_norm():
    jm, tm = _apg("none", batch_norm=True, decompose_ranks=None)
    compare(jm, tm, [_x(4, B, 6)], train=True, grads=True)


def test_apg_mlp_single_mode():
    """One hypernetwork per layer, of the conditions."""
    jm, tm = _apg("single", meta_net_configs=dict(META, input_dim=3),
                  overparam_dims=[None, 3, None])
    compare(jm, tm, [_x(5, B, 6), _x(6, B, 3)], train=False, grads=True)


def test_apg_mlp_meta_configs_per_layer():
    """meta_net_configs as a list, one per layer, builds what the one dict
    builds when the entries are equal (the JAX module cannot take the
    list: flax turns it into a tuple, which it then reads as one dict)."""
    meta = dict(META, input_dim=3)
    jm, _ = _apg("single", meta_net_configs=meta)
    tm = td.APGMLPLayer(input_dim=6, output_dim=1, hidden_units=(5, 4),
                        condition_mode="single", decompose_ranks=2,
                        meta_net_configs=[meta] * 3)
    compare(jm, tm, [_x(5, B, 6), _x(6, B, 3)], train=False, grads=True)


def test_apg_mlp_self_mode():
    jm, tm = _apg("self", meta_net_configs=META, decompose_ranks=[2, None, 2],
                  batch_norm=True)
    compare(jm, tm, [_x(7, B, 6)], train=True, grads=True)


@pytest.mark.parametrize("aggregation", ["mean", "sum", "max", "attention"])
def test_apg_mlp_moe_mode(aggregation):
    """Three experts per layer over conditions [B, 3, 3]; with attention,
    condition_lens masks the experts at and past each row's length, and
    the row of length 0 aggregates to zeros (softmax of all -inf, then
    nan_to_num)."""
    meta = dict(META, input_dim=3, num_experts=3, aggregation=aggregation)
    jm, tm = _apg("moe", meta_net_configs=meta)
    lens = np.array([0, 1, 2, 3, 3, 2, 1, 3], np.int32)
    compare(jm, tm, [_x(8, B, 6), _x(9, B, 3, 3), lens], train=False, grads=True)


@pytest.mark.parametrize("norm", ["batch_norm", "layer_norm", "none"])
@pytest.mark.parametrize("before", [True, False], ids=["before_act", "after_act"])
def test_mlp_block(norm, before):
    kw = dict(hidden_units=(6, 5), hidden_activations=["relu", "tanh"], output_dim=2,
              norm_before_activation=before, batch_norm=norm == "batch_norm",
              layer_norm=norm == "layer_norm")
    compare(jd.MLPBlock(input_dim=7, **kw), td.MLPBlock(7, **kw), [_x(10, B, 7)],
            train=True, grads=True)


def test_pre_norm():
    """LayerNorm, then the wrapped module (flax's ``fn``)."""
    kw = dict(output_dim=3, hidden_units=(6,))
    compare(jl.PreNorm(jl.MLPLayer(input_dim=7, **kw)), tl.PreNorm(7, tl.MLPLayer(7, **kw)),
            [_x(11, B, 7)], grads=True)
