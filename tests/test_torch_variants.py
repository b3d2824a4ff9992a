"""The rest of the RAT model in the port against the JAX package, on the
CPU: RAT_m0 (JointEncoder), RAT_m1 (CascadeEncoder), RAT_m3
(CrossIntraEncoderPA, halved heads) and RAT_m2 with BatchNorm and
dropout; every config in configs/ built, and the fused path's gate;
multi-epoch fits against the JAX Trainer; chip_smoke's kkbox_train and
variants phases as functions at a tiny size.

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
from rat_tpu.data.loader import h5_generator as jax_h5_generator
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu.engine.optim import get_learning_rate as jax_get_lr
from rat_tpu.engine.optim import regularization_loss as jax_reg
from rat_tpu.engine.trainer import _bce as jax_bce
from rat_tpu.features import FeatureMap as JFeatureMap
from rat_tpu.models import build_model as jbuild
from rat_tpu_torch.convert import params_from_jax, torch_name
from rat_tpu_torch.data.loader import h5_generator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_learning_rate, regularization_loss
from rat_tpu_torch.engine.trainer import _bce
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.models import build_model
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1
from rat_tpu_torch.utils import load_config
from tests.test_torch_train import BATCH, K, _record, _rows, _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---- fits against the JAX Trainer ----------------------------------------

def _retrieval(used_cols):
    return {"used_cols": list(used_cols), "exact_match_cols": [], "split_type": "10-fold",
            "label_wise": False, "pre_retrieval": True, "qry_batch_size": 100,
            "db_chunk_size": 256, "topK": K}


def _fit_pair(tmp_path, jfm, params, train, valid, used_cols):
    """(JAX trainer, its generators, port trainer, its generators) over
    the same h5 splits, the port's weights and batch statistics copied
    from the JAX init."""
    kw = dict(stage="train", batch_size=BATCH, shuffle=True, retrieval_augmented=True)
    jtrain, jvalid = _write(str(tmp_path / "jax"), train, valid)
    jgens = jax_h5_generator(jfm, train_data=jtrain, valid_data=jvalid,
                             retrieval_configs=_retrieval(used_cols), **kw)
    jtr = JaxTrainer(jfm, params)
    jtr.init_state(np.zeros((2, 1 + K, jfm.input_length), np.int32),
                   np.zeros((2, 1 + K), np.float32))
    fm = _port_map(jfm)
    ttrain, tvalid = _write(str(tmp_path / "torch"), train, valid)
    gens = h5_generator(fm, train_data=ttrain, valid_data=tvalid, device="cpu",
                        retrieval_configs=_retrieval(used_cols), **kw)
    tr = Trainer(fm, params, device="cpu")
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params),
                                             jax.device_get(jtr.state.batch_stats)))
    return jtr, jgens, tr, gens


def _fit_both(jtr, jgens, tr, gens, epochs):
    jlosses, jevals = _record(jtr)
    losses, evals = _record(tr)
    jtr.fit(jgens[0], validation_data=jgens[1], epochs=epochs)
    tr.fit(gens[0], validation_data=gens[1], epochs=epochs)
    assert len(losses) == len(jlosses) and len(evals) == len(jevals) >= 3
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-4)
    for ours, theirs in zip(evals, jevals):
        for k in ("AUC", "logloss"):
            assert abs(ours[k] - theirs[k]) < 1e-3, (evals, jevals)
    assert np.isclose(get_learning_rate(tr.optimizer), jax_get_lr(jtr.state.opt_state),
                      rtol=1e-6)
    return losses, evals


@pytest.mark.parametrize("model", ["RAT_m0", "RAT_m1", "RAT_m3"])
def test_demo_fit_trajectory_matches_jax(tmp_path, tiny_feature_map, model):
    """The configs/demo expid of each variant (d=10, 2 heads x 10, depth
    2, DNN 64x64, embedding regularizer 0.03) on tiny ML-Tag-like
    splits, with the batch, learning rate and epochs cut to the data
    (64, 1e-2, up to 12 epochs, patience 3, so that the LR decays and the
    run stops early), from the same init and batch order. Tolerances as
    the RAT_m2 trajectory (tests/test_torch_train.py): per-epoch loss
    atol 2e-4, each eval's AUC and logloss within 1e-3, the same number
    of epochs and evaluations, the final LR within rtol 1e-6."""
    params = load_config(os.path.join(REPO, "configs", "demo"),
                         "{}_demo_10fold_retrieval".format(model))
    params.update(batch_size=BATCH, learning_rate=1e-2, epochs=12, patience=3,
                  model_root=str(tmp_path / "exps"), train_scan_batches=0)
    rng = np.random.RandomState(17)
    pair = _fit_pair(tmp_path, tiny_feature_map, params, _rows(rng, 700), _rows(rng, 256),
                     ["user_id", "item_id", "tag_id"])
    losses, evals = _fit_both(*pair, epochs=12)
    tr = pair[2]
    assert len(losses) < 12 and get_learning_rate(tr.optimizer) < 1e-2
    assert evals[-1]["AUC"] > 0.7
    tr.load_weights(tr.checkpoint)
    assert tr.evaluate(pair[3][1])["AUC"] == pytest.approx(tr._best_metric, abs=1e-12)


def _kkbox_like(rng, n):
    """[a, b, genre x3, artist x3, c, label] rows of the KKBox-like map:
    sequences of 1 to 3 ids padded with vocab - 1, a learnable label."""
    a, b, c = rng.randint(0, 12, n), rng.randint(0, 9, n), rng.randint(0, 5, n)
    seqs = []
    for vocab in (8, 10):
        ids = rng.randint(0, vocab - 1, (n, 3))
        ids[np.arange(3)[None, :] >= rng.randint(1, 4, (n, 1))] = vocab - 1
        seqs.append(ids)
    logit = 1.1 * (a % 3 == 0) + 0.8 * (seqs[0][:, 0] % 2 == 0) + 0.6 * (c == 1) - 1.0
    y = rng.rand(n) < 1.0 / (1.0 + np.exp(-2.5 * logit))
    return np.concatenate([a[:, None], b[:, None], seqs[0], seqs[1], c[:, None],
                           y[:, None]], axis=1).astype(np.float64)


def test_batchnorm_fit_trajectory_matches_jax(tmp_path, demo_params):
    """RAT_m2 with BatchNorm on a tiny KKBox-like map (two MaskedSumPooling
    sequence fields) and dropout 0, so both packages are deterministic,
    for 6 epochs at the demo's learning rate on a fixed schedule (no LR
    plateau, no early stop). Per-epoch train loss within atol 2e-4 (the
    trajectory tolerance; they agree to ~1e-6) and the final running
    variances within rtol 1e-5 / atol 1e-6.

    The running means and the eval metrics are held more loosely, and
    why: the gradient of the Dense bias in front of a BatchNorm is zero
    in exact arithmetic (the batch mean is subtracted), so each package
    gets float32 noise of ~1e-9 there, and Adam turns noise of either
    sign into steps of up to ~lr. Those biases random-walk differently
    in the two packages (by ~0.02 after 66 steps at lr 1e-3) while every
    training output stays the same; the running means track the walk,
    and eval-mode logits see it through (bias - running mean) divided by
    a running std of ~0.02 here. Measured: eval AUC and logloss apart by
    up to 3.3e-3, so they are held within 1e-2. The update rule of the
    running statistics is held exactly (1e-6) in one step by
    test_variant_matches_jax and tests/test_torch_layers.py."""
    jfm = JFeatureMap("kk", str(tmp_path))
    jfm.feature_specs = {
        "a": {"type": "categorical", "vocab_size": 12},
        "b": {"type": "categorical", "vocab_size": 9},
        "genre": {"type": "sequence", "vocab_size": 8, "max_len": 3,
                  "encoder": "MaskedSumPooling"},
        "artist": {"type": "sequence", "vocab_size": 10, "max_len": 3,
                   "encoder": "MaskedSumPooling"},
        "c": {"type": "categorical", "vocab_size": 5},
    }
    jfm.set_feature_index()
    jfm.num_fields, jfm.num_features = 5, 44
    params = dict(demo_params, depth=2, batch_size=BATCH, batch_norm=True,
                  learning_rate=1e-3, patience=100, reduce_lr_on_plateau=False,
                  model_root=str(tmp_path / "exps"), train_scan_batches=0)
    rng = np.random.RandomState(23)
    jtr, jgens, tr, gens = _fit_pair(tmp_path, jfm, params, _kkbox_like(rng, 700),
                                     _kkbox_like(rng, 256), ["a", "b", "c"])
    assert len(gens[0].darray) % BATCH and not tr._use_fast_forward()
    jlosses, jevals = _record(jtr)
    losses, evals = _record(tr)
    jtr.fit(jgens[0], validation_data=jgens[1], epochs=6)
    tr.fit(gens[0], validation_data=gens[1], epochs=6)
    assert len(losses) == len(jlosses) == len(evals) == len(jevals) == 6
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-4)
    for ours, theirs in zip(evals, jevals):
        for k in ("AUC", "logloss"):
            assert abs(ours[k] - theirs[k]) < 1e-2, (evals, jevals)
    state = tr.model.state_dict()
    stats = params_from_jax({}, jax.device_get(jtr.state.batch_stats))
    assert len(stats) == 4
    for name, want in stats.items():
        assert not np.allclose(want.numpy(), 0.0 if "mean" in name else 1.0), name
        assert not np.allclose(state[name].numpy(), 0.0 if "mean" in name else 1.0), name
        if "var" in name:
            np.testing.assert_allclose(state[name].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


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
    assert res["launches"] == {"cross_intra_block": 0, "bm25_topk": 0}
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
