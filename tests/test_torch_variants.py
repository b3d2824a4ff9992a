"""The rest of the RAT model in the port against the JAX package, on the
CPU: RAT_m0 (JointEncoder), RAT_m1 (CascadeEncoder), RAT_m3
(CrossIntraEncoderPA, halved heads) and RAT_m2 with BatchNorm and
dropout; every config in configs/ built, and the fused path's gate;
chip_smoke's kkbox_train and variants phases as functions at a tiny
size. The multi-epoch fits against the JAX Trainer are in
tests/test_torch_variants_fit.py.

Both packages start from the JAX init (``params_from_jax``, batch
statistics included). Tolerances are stated in each test."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu.engine.optim import regularization_loss as jax_reg
from rat_tpu.engine.trainer import _bce as jax_bce
from rat_tpu.features import FeatureMap as JFeatureMap
from rat_tpu.models import build_model as jbuild
from rat_tpu_torch.convert import params_from_jax, torch_name
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import regularization_loss
from rat_tpu_torch.engine.trainer import _bce
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.models import build_model
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1
from rat_tpu_torch.utils import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _port_map(jfm):
    fm = FeatureMap(jfm.dataset_id, jfm.data_dir)
    fm.from_dict(jfm.to_dict())
    return fm


# ---- forward and gradient parity ---------------------------------------

def _parity_map(tmp_path):
    """Categorical, sequence (MaskedAveragePooling) and numeric fields."""
    fm = JFeatureMap("variants", str(tmp_path))
    fm.feature_specs = {
        "user": {"type": "categorical", "vocab_size": 12, "index": 0},
        "genre": {"type": "sequence", "vocab_size": 7, "index": [1, 2, 3], "max_len": 3,
                  "encoder": "MaskedAveragePooling"},
        "price": {"type": "numeric", "index": 4},
        "item": {"type": "categorical", "vocab_size": 10, "index": 5},
    }
    fm.num_fields, fm.num_features, fm.input_length = 4, 29, 6
    return fm


VARIANT_CASES = [("RAT_m0", 2), ("RAT_m0", 4), ("RAT_m1", 2), ("RAT_m1", 4),
                 ("RAT_m3", 2), ("RAT_m3", 4), ("RAT_m2", 2)]


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("model,heads", VARIANT_CASES,
                         ids=["{}_h{}".format(m, h) for m, h in VARIANT_CASES])
def test_variant_matches_jax(tmp_path, model, heads, mode):
    """Each variant with BatchNorm on, a numeric and a sequence field,
    the wide tower, depth 2: in eval mode with every dropout at 0.1
    (dropout is then the identity) on moved running statistics, and in
    training mode with dropout 0. Logits within rtol 1e-5 / atol 1e-5,
    the loss within 1e-5; in training the updated running statistics
    within rtol 1e-5 / atol 1e-6. The gradient of BCE plus both
    regularizers, for every parameter, within rtol 1e-5 and an atol of
    1e-7 plus a share of the tensor's largest gradient: 1e-5 in eval
    mode, 5e-4 in training mode. That share is the float32 noise of the
    backward: against the same step in float64 (the port's model in
    double), both packages' float32 gradients are off by up to 2.8e-6
    of the scale in eval mode (the numeric weights, a sum over values
    of both signs), and by up to 1.6e-4 in training mode, where the
    backward of BatchNorm over 8 rows subtracts nearly equal terms
    (measured over these 14 cases). The Dense biases in front of a
    training-mode BatchNorm have a zero gradient in exact arithmetic;
    there both packages' float32 noise is held under 2e-6. RAT_m3 at 4
    heads runs 2 heads of width 8 per branch, scaled by 4 ** -0.5, not
    8 ** -0.5."""
    jfm = _parity_map(tmp_path)
    rate = 0.1 if mode == "eval" else 0.0
    params = {"model": model, "embedding_dim": 8, "dnn_hidden_units": [16, 16],
              "num_heads": heads, "dim_head": 4, "depth": 2, "scale_dim": 2,
              "use_wide": True, "batch_norm": True, "dropout": rate,
              "emb_dropout": rate, "net_dropout": rate, "seed": 3}
    rng = np.random.RandomState(9)
    X = np.stack([rng.randint(0, 12, (8, 4)), rng.randint(0, 7, (8, 4)),
                  rng.randint(0, 7, (8, 4)), np.full((8, 4), 6), np.zeros((8, 4)),
                  rng.randint(0, 10, (8, 4))], axis=-1).astype(np.int32)
    Xf = rng.randn(8, 4, 6).astype(np.float32)
    y = rng.randint(0, 2, (8, 4)).astype(np.float32)
    args = [jnp.asarray(a) for a in (X, y, Xf)]

    jmodel = jbuild(jfm, params)
    v = jmodel.init({"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)},
                    *args, train=False)
    _, moved = jmodel.apply(v, *args, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(6)})
    stats = moved["batch_stats"]

    def jloss(p):
        variables = {"params": p, "batch_stats": stats}
        if mode == "train":
            out, new = jmodel.apply(variables, *args, train=True, mutable=["batch_stats"])
        else:
            out, new = jmodel.apply(variables, *args, train=False), {}
        pred = out["y_pred"][:, 0]
        loss = jnp.mean(jax_bce(pred, out["y_true"][:, 0])) + jax_reg(p, 0.01, 0.001)
        return loss, (pred, new)

    (jl, (jpred, new)), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])

    net = build_model(_port_map(jfm), params)
    net.load_state_dict(params_from_jax(jax.device_get(v["params"]),
                                        jax.device_get(stats)))
    net.train(mode == "train")
    out = net(torch.from_numpy(X).long(), torch.from_numpy(y), torch.from_numpy(Xf))
    pred = out["y_pred"][:, 0]
    loss = _bce(pred, out["y_true"][:, 0]).mean() + regularization_loss(
        net.named_parameters(), 0.01, 0.001)
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-5)
    assert abs(loss.item() - float(jl)) <= 1e-5
    want = params_from_jax(jax.device_get(jg))
    share = 5e-4 if mode == "train" else 1e-5
    for name, w in net.named_parameters():
        if mode == "train" and name in ("dnn.linears.0.bias", "dnn.linears.1.bias"):
            # a Dense bias in front of a training-mode BatchNorm has a zero
            # gradient in exact arithmetic: both are float32 noise
            assert w.grad.abs().max() < 2e-6 and want[name].abs().max() < 2e-6
            continue
        np.testing.assert_allclose(w.grad.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7 + share * want[name].abs().max().item(),
                                   err_msg=name)
    if mode == "train":
        state = net.state_dict()
        for name, b in params_from_jax({}, jax.device_get(new["batch_stats"])).items():
            np.testing.assert_allclose(state[name].numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_m3_needs_two_heads(tmp_path):
    with pytest.raises(ValueError, match="num_heads"):
        build_model(_port_map(_parity_map(tmp_path)),
                    {"model": "RAT_m3", "embedding_dim": 8, "num_heads": 1, "dim_head": 8})


# ---- every config: build, names, the fused path's gate -------------------

def _expids():
    """(config directory, experiment id) of every experiment in configs/."""
    import yaml
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "**", "model_config.yaml"),
                                 recursive=True)):
        with open(path) as fh:
            out += [(os.path.dirname(path), expid) for expid in yaml.safe_load(fh)
                    if expid != "Base"]
    return out


CONFIGS = _expids()


def _config_feature_map(params, tmp_path):
    """A feature map with the config's dataset's fields, in its column
    order and of its types (sequence fields with their max_len and
    pooling), over small vocabularies."""
    specs = {}
    for col in params["feature_cols"]:
        if not col.get("active", True):
            continue
        for name in col["name"] if isinstance(col["name"], list) else [col["name"]]:
            specs[name] = {"type": col["type"], "vocab_size": 30}
            if col["type"] == "sequence":
                specs[name].update(max_len=col["max_len"],
                                   encoder=col.get("encoder", "MaskedAveragePooling"))
    jfm = JFeatureMap(params["dataset_id"], str(tmp_path))
    jfm.feature_specs.update(specs)
    jfm.set_feature_index()
    jfm.num_fields, jfm.num_features = len(specs), 30 * len(specs)
    return jfm


def test_every_config_is_listed():
    names = {e for _, e in CONFIGS}
    assert len(CONFIGS) == 10 and "RAT_m2_kkbox_x1_10fold_retrieval" in names \
        and "RAT_m2_tmall_x1_002_retrieval" in names \
        and {"RAT_m{}_demo_10fold_retrieval".format(i) for i in range(4)} <= names


@pytest.mark.parametrize("config_dir,expid", CONFIGS, ids=[e for _, e in CONFIGS])
def test_config_builds_like_jax(tmp_path, config_dir, expid):
    """``build_model`` builds the config's model block over a feature map
    of its dataset's field types; its state dict holds exactly the
    counterparts of the JAX model's parameters and batch statistics, of
    the same sizes; and the fused path's gate agrees with the JAX
    Trainer's, with ``use_pallas`` on and off."""
    params = load_config(config_dir, expid)
    params["model_root"] = str(tmp_path)
    jfm = _config_feature_map(params, tmp_path)
    model = build_model(_port_map(jfm), params)
    jmodel = jbuild(jfm, params)
    X = np.zeros((2, 3, jfm.input_length), np.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        X, np.zeros((2, 3), np.float32), train=False))
    want = {torch_name("/".join(k.key for k in path[1:]))[0]: int(np.prod(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v.numel() for k, v in model.state_dict().items()} == want
    assert model.batch_norm == bool(params.get("batch_norm")) and \
        model.emb_dropout == params.get("emb_dropout", 0.)
    for use_pallas in (True, False):
        p = dict(params, use_pallas=use_pallas)
        assert Trainer(_port_map(jfm), p, device="cpu")._use_fast_forward() == \
            JaxTrainer(jfm, p)._use_fast_forward()


@pytest.mark.parametrize("edit", [{}, {"dropout": 0.1}, {"emb_dropout": 0.1},
                                  {"net_dropout": 0.1}, {"batch_norm": True},
                                  {"dnn_activations": "tanh"},
                                  {"neighbor_padding": "mask"}, {"model": "RAT_m3"}],
                         ids=["plain", "dropout", "emb_dropout", "net_dropout",
                              "batch_norm", "tanh", "mask_padding", "m3"])
def test_fast_forward_gate_matches_jax(tmp_path, tiny_feature_map, demo_params, edit):
    """The JAX gate: only ``use_pallas`` RAT_m2 without dropout of any
    kind, without BatchNorm, with a relu DNN and wrap padding takes the
    fused path."""
    params = dict(demo_params, use_pallas=True, model_root=str(tmp_path), **edit)
    got = Trainer(_port_map(tiny_feature_map), params, device="cpu")._use_fast_forward()
    assert got == JaxTrainer(tiny_feature_map, params)._use_fast_forward() == (not edit)


# ---- chip_smoke's new phases at a tiny size ------------------------------

KKBOX_TINY_VOCAB = {k: min(v, 40) for k, v in chip_smoke.KKBOX_VOCAB.items()}


def test_chip_smoke_kkbox_phase_on_cpu(tmp_path):
    train, valid = chip_smoke.kkbox_arrays(0, 2000, 400, vocab=KKBOX_TINY_VOCAB)
    fm = chip_smoke.kkbox_feature_map(KKBOX_TINY_VOCAB)
    assert train.shape == (2000, fm.input_length + 1) == (2000, 18)
    for name in chip_smoke.KKBOX_SEQUENCES:
        cols = train[:, fm.feature_specs[name]["index"]]
        pad = fm.feature_specs[name]["vocab_size"] - 1
        assert (cols[:, 0] != pad).all() and (cols == pad).any()
    before = (k1.launches, k2.launches)
    trainer, gen, res = chip_smoke.kkbox_train("cpu", 0, train, valid, 64,
                                               str(tmp_path), vocab=KKBOX_TINY_VOCAB)
    assert (k1.launches, k2.launches) == before
    none = {"forward": 0, "backward": 0, "plain": 0}
    assert res["launches"] == {"cross_intra_block": 0, "bm25_topk": 0, "embedding_grad": 0,
                               "attention_fit": none, "attention": none}
    assert res["steps"] == len(gen) == 32 and res["valid_batches"] == 7
    assert res["fields"] == 13 and res["retrieval_fields"] == 11
    assert res["neighbours_checked"] == 400 and res["card_vs_cpu_logits_max_abs_err"] == 0
    assert res["AUC"] == pytest.approx(res["best_AUC"], abs=1e-6) and res["AUC"] > 0.55
    assert trainer.model.batch_norm and not trainer._use_fast_forward()


def test_chip_smoke_variants_phase_on_cpu(tmp_path):
    vocab = {"user_id": 60, "item_id": 80, "tag_id": 120}
    pool, test = chip_smoke.mltag_arrays(0, 3000, 300, vocab=vocab)
    trainer, gen, _ = chip_smoke.train("cpu", 0, pool, test, 64, str(tmp_path))
    out = chip_smoke.variants("cpu", 0, gen, trainer.valid_gen, 64, str(tmp_path))
    assert sorted(out) == ["RAT_m0", "RAT_m1", "RAT_m3"]
    for name, res in out.items():
        assert res["steps"] == 47 and res["launches"] == {"cross_intra_block": 0,
                                                          "bm25_topk": 0}
        assert res["one_step"] == {"loss_abs_err": 0.0, "grad_max_abs_err": 0.0}
        assert res["AUC"] > 0.55, (name, res)
        assert os.path.exists(os.path.join(str(tmp_path), name))


def test_chip_smoke_nnlib_phase_on_cpu():
    """The nnlib phase at a tiny size on the CPU (16 groups, KKBox's map
    with vocabularies cut to 40): every layer family runs, its copy held
    to the module within the phase's tolerances; no time or memory is
    read off a card."""
    out = chip_smoke.nnlib("cpu", 0, batch_size=16, vocab=KKBOX_TINY_VOCAB)
    assert list(out) == ["embeddings", "interactions", "tower", "target_attention", "apg",
                         "graphs"]
    assert [len(layers) for layers in out.values()] == [3, 13, 6, 3, 2, 2]
    for layers in out.values():
        for res in layers.values():
            assert res["out_worst"] <= 1 and res["grad_worst"] <= 1, res
            assert res["ms"] is None and res["peak_mib"] is None
    pet = out["graphs"]["PET_Layer"]
    assert pet["graphs"] == 16 and pet["edges"] == 16 * 6 * 17 * 2


def test_chip_smoke_layer_check_reruns_misses_in_float64():
    """A float32 run that misses the tolerance (here: the copy's call is
    off by 1e-3) is made again in float64 on both sides and held there;
    a float64 miss (the copy off again) is reported as one."""
    calls = []

    class Drifting(torch.nn.Module):
        def __init__(self, drift64):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))
            self.drift64 = drift64

        def forward(self, x):
            calls.append(x.dtype)
            drift = len(calls) == 2 or (self.drift64 and len(calls) == 4)
            return x * self.w + (1e-3 if drift else 0.0)

    for drift64 in (False, True):
        calls.clear()
        res = chip_smoke._hold_layer(Drifting(drift64), [torch.ones(4, 3)], "cpu")
        assert not chip_smoke._held(res) and res["out_err"] > 9e-4
        assert chip_smoke._held(res["float64"]) == (not drift64)
        assert calls == [torch.float32, torch.float32, torch.float64, torch.float64]
