"""Multi-epoch fits of the port against the JAX Trainer, on the CPU:
the demo expids of RAT_m0, RAT_m1 and RAT_m3, and RAT_m2 with BatchNorm
on a tiny KKBox-like map. Moved out of tests/test_torch_variants.py so
that the test workers can run the two files apart.

Both packages start from the JAX init (``params_from_jax``, batch
statistics included). Tolerances are stated in each test."""

import os

import jax
import numpy as np
import pytest
import torch

from rat_tpu.data.loader import h5_generator as jax_h5_generator
from rat_tpu.engine import Trainer as JaxTrainer
from rat_tpu.engine.optim import get_learning_rate as jax_get_lr
from rat_tpu.features import FeatureMap as JFeatureMap
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.data.loader import h5_generator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_learning_rate
from rat_tpu_torch.utils import load_config
from tests.test_torch_train import BATCH, K, _record, _rows, _write
from tests.test_torch_variants import REPO, _port_map


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


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
