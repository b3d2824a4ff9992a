"""The slice as a whole: training RAT_m2 with 10-fold self-retrieval, the
port against the JAX package, on the CPU.

Seeded ML-Tag-shaped splits are written to h5, one directory per
package, and both run ``h5_generator(stage="train")``: the train split
retrieves from itself fold by fold, the valid split from the train
split. The port's model starts from the JAX package's weights
(``params_from_jax``), both with ``use_pallas: true`` (the JAX package
then runs its block's plain version on the CPU, as its own tests do).
Then chip_smoke's train phase runs as a function at a tiny size."""

import os

import h5py
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
from rat_tpu.engine.trainer import _gather_batch as jax_gather
from rat_tpu.models.fast_forward import rat_m2_fast_forward as jax_fast
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.data.loader import h5_generator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_learning_rate
from rat_tpu_torch.engine.trainer import _bce, get_loss_fn
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1

K = 3
BATCH = 64


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _rows(rng, n):
    """[user, item, tag, label] rows over the tiny feature map's
    vocabularies (20, 15, 10), with a learnable signal."""
    u, i, t = rng.randint(0, 20, n), rng.randint(0, 15, n), rng.randint(0, 10, n)
    logit = 1.2 * (u % 3 == 0) + 0.9 * (i % 2 == 0) + 0.5 * (t % 4 == 0) - 1.3
    y = rng.rand(n) < 1.0 / (1.0 + np.exp(-2.5 * logit))
    return np.stack([u, i, t, y], axis=1).astype(np.float64)


def _retrieval_configs():
    return {"used_cols": ["user_id", "item_id", "tag_id"], "exact_match_cols": [],
            "split_type": "10-fold", "label_wise": False, "pre_retrieval": True,
            "qry_batch_size": 100, "db_chunk_size": 256, "topK": K}


def _write(root, train, valid):
    os.makedirs(root)
    paths = []
    for name, arr in (("train.h5", train), ("valid.h5", valid)):
        paths.append(os.path.join(root, name))
        with h5py.File(paths[-1], "w") as hf:
            hf.create_dataset("data", data=arr)
    return paths


def _pair(tmp_path, fm, params, n_train=700, n_valid=256):
    """(JAX trainer, its train/valid generators, port trainer, its
    generators), the port's weights copied from the JAX init. Both
    consume equal retrieval results."""
    rng = np.random.RandomState(17)
    train, valid = _rows(rng, n_train), _rows(rng, n_valid)
    kw = dict(stage="train", batch_size=BATCH, shuffle=True,
              retrieval_configs=_retrieval_configs(), retrieval_augmented=True)
    jtrain_h5, jvalid_h5 = _write(str(tmp_path / "jax"), train, valid)
    jgens = jax_h5_generator(fm, train_data=jtrain_h5, valid_data=jvalid_h5, **kw)
    jtr = JaxTrainer(fm, params)
    jtr.init_state(np.zeros((2, 1 + K, 3), np.int32), np.zeros((2, 1 + K), np.float32))

    pfm = FeatureMap(fm.dataset_id, fm.data_dir)
    pfm.from_dict(fm.to_dict())
    train_h5, valid_h5 = _write(str(tmp_path / "torch"), train, valid)
    gens = h5_generator(pfm, train_data=train_h5, valid_data=valid_h5, device="cpu",
                        **kw)
    for g, jg in zip(gens, jgens):
        for name in ("retr_indices", "retr_values", "retr_lens"):
            np.testing.assert_array_equal(getattr(g, name), getattr(jg, name))
    tr = Trainer(pfm, params, device="cpu")
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.state.params)))
    return jtr, jgens, tr, gens


@pytest.fixture()
def train_params(demo_params, tmp_path):
    return dict(demo_params, depth=2, batch_size=BATCH, use_pallas=True,
                model_root=str(tmp_path / "exps"), train_scan_batches=0)


def _jax_loss_and_grads(jtr, jdata, idx, valid, use_pallas):
    """The loss of the JAX package's train step (trainer.py:490-515),
    from its own functions, and its gradients."""
    model, p = jtr.model, jtr.params

    def loss_fn(params):
        X, y, Xf, nmask = jax_gather(jdata, jnp.asarray(idx))
        if use_pallas:
            out = jax_fast(params, model, X, y, Xf)
        else:
            out = model.apply({"params": params}, X, y, Xf, train=True,
                              nbr_mask=nmask, rngs={"dropout": jax.random.PRNGKey(0)})
        pred, target = out["y_pred"][:, 0], out["y_true"][:, 0]
        mask = (jnp.arange(pred.shape[0]) < valid).astype(pred.dtype)
        loss = jnp.sum(jax_bce(pred, target) * mask) / np.float32(valid)
        return loss + jax_reg(params, p["embedding_regularizer"], p["net_regularizer"])

    return jax.jit(jax.value_and_grad(loss_fn))(jtr.state.params)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
@pytest.mark.parametrize("which", ["first", "padded_last"])
def test_train_step_matches_jax(tmp_path, tiny_feature_map, train_params,
                                use_pallas, which):
    """One step from the same weights and batch, the padded final batch
    included: the loss, regularizer included, within 1e-6, and every
    gradient within rtol 1e-5 and an atol of 1e-7 plus 1e-6 of the
    tensor's largest gradient. The second atol term is for float32
    noise that grows with the gradient: against the same step in
    float64 (the port's model in double), both packages' float32
    gradients are off by up to ~5e-7 of the tensor's scale (the JAX
    package's up to 1.05e-6 on a small bias), which is above 1e-7 for
    the embedding table's gradients of scale ~2.5. Where a gradient is a
    sum that cancels (fc.bias, LayerNorm biases) the noise follows its
    summands, not its result, and stays below 5e-8. Gradients, not
    parameters after Adam: Adam's first step is about +-lr on every
    coordinate, so a near-zero gradient whose sign differs by float
    noise would move a parameter by 2 lr."""
    params = dict(train_params, use_pallas=use_pallas)
    jtr, (jtrain, _), tr, (train, _) = _pair(tmp_path, tiny_feature_map, params)
    assert tr._use_fast_forward() == use_pallas == jtr._use_fast_forward()
    jbatches = list(jtrain.epoch_index_batches(rng=np.random.RandomState(0)))
    batches = list(train.epoch_index_batches(rng=np.random.RandomState(0)))
    pick = 0 if which == "first" else -1
    (jidx, jvalid), (idx, valid) = jbatches[pick], batches[pick]
    np.testing.assert_array_equal(jidx, idx)
    assert valid == jvalid and (valid < BATCH) == (which == "padded_last")

    jdata = jtr.device_split(jtrain)
    jloss, jgrads = _jax_loss_and_grads(jtr, jdata, jidx, jvalid, use_pallas)
    # the reconstruction is the JAX Trainer's own step
    jtr._build_steps()
    _, step_loss = jtr._jit_train_step(jtr.state, jdata, jnp.asarray(jidx),
                                       np.float32(jvalid), jtr._rng)
    assert float(step_loss) == pytest.approx(float(jloss), rel=1e-6)

    launches = k1.launches
    loss = tr.loss_and_grads(tr.device_split(train), torch.from_numpy(idx), valid)
    assert k1.launches == launches, "CPU calls count no launch"
    assert abs(float(loss) - float(jloss)) <= 1e-6, (float(loss), float(jloss))
    want = params_from_jax(jax.device_get(jgrads))
    for name, w in tr.model.named_parameters():
        got = torch.zeros_like(w) if w.grad is None else w.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7 + 1e-6 * want[name].abs().max().item(),
                                   err_msg=name)


def _record(trainer):
    """Wrap train_one_epoch and evaluate to record each epoch's loss and
    each evaluation's metrics."""
    losses, evals = [], []
    epoch, evaluate = trainer.train_one_epoch, trainer.evaluate

    def rec_epoch(gen, e):
        out = epoch(gen, e)
        losses.append(float(out[0]))
        return out

    def rec_eval(gen, data=None):
        logs = evaluate(gen, data)
        evals.append(dict(logs))
        return logs

    trainer.train_one_epoch, trainer.evaluate = rec_epoch, rec_eval
    return losses, evals


def test_fit_trajectory_matches_jax(tmp_path, tiny_feature_map, train_params):
    """A multi-epoch fit from the same init and the same batch order
    (both shuffle with RandomState(seed)), run until the LR decays and
    the run stops early. Tolerances, from tests/test_trajectory_parity.py:
    per-epoch train loss within atol 2e-4, since float32 differences in
    the step compound over the epochs; each eval's AUC and logloss
    within 1e-3, since Adam divides by sqrt(v) ~ 0 early on the 1e-4-std
    embedding init, so the sign of ~1e-8 gradient noise can flip whole
    +-lr steps on single coordinates; the same stop epoch, and the final
    LR within rtol 1e-6 (it decays in x0.1 steps, so equality pins the
    same plateau events)."""
    lr, epochs = 1e-2, 12
    params = dict(train_params, learning_rate=lr, patience=3, epochs=epochs)
    jtr, (jtrain, jvalid), tr, (train, valid) = _pair(tmp_path, tiny_feature_map, params)
    jlosses, jevals = _record(jtr)
    losses, evals = _record(tr)
    jtr.fit(jtrain, validation_data=jvalid, epochs=epochs)
    tr.fit(train, validation_data=valid, epochs=epochs)

    assert len(losses) == len(jlosses) < epochs, (losses, jlosses)
    assert len(evals) == len(jevals) >= 3
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-4)
    for ours, theirs in zip(evals, jevals):
        for k in ("AUC", "logloss"):
            assert abs(ours[k] - theirs[k]) < 1e-3, (evals, jevals)
    final_lr = get_learning_rate(tr.optimizer)
    assert final_lr < lr and np.isclose(final_lr, jax_get_lr(jtr.state.opt_state),
                                        rtol=1e-6)
    assert evals[-1]["AUC"] > 0.7 and len(tr.step_losses) == len(losses) * len(train)
    # the best checkpoint reloads to the monitored value
    tr.load_weights(tr.checkpoint)
    assert tr.evaluate(valid)["AUC"] == pytest.approx(tr._best_metric, abs=1e-12)


def test_bce_and_loss_names_match_jax():
    pred = np.array([0.0, 1e-30, 0.3, 0.999, 1.0], np.float32)
    for target in (np.zeros(5, np.float32), np.ones(5, np.float32)):
        got = _bce(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
        # the port's loss is torch's binary cross-entropy, exactly
        np.testing.assert_array_equal(got, torch.nn.functional.binary_cross_entropy(
            torch.from_numpy(pred), torch.from_numpy(target), reduction="none").numpy())
        # and the JAX package's wherever p and 1 - p are not rounded away:
        # at p = 1e-30, target 0, JAX's log(1 - p) is log(1) = 0 where
        # torch's log1p(-p) gives p (the saturated rows, where the port
        # departs from the JAX package's loss and its NaN gradient)
        kept = ~((pred == np.float32(1e-30)) & (target == 0))
        np.testing.assert_allclose(
            got[kept], np.asarray(jax_bce(jnp.asarray(pred), jnp.asarray(target)))[kept],
            rtol=1e-6)
    assert get_loss_fn("binary_crossentropy") is _bce
    assert float(get_loss_fn("mse")(torch.tensor(3.0), torch.tensor(1.0))) == 4.0
    with pytest.raises(NotImplementedError):
        get_loss_fn("hinge")


def test_lr_plateau_and_early_stop(tiny_feature_map, train_params):
    tr = Trainer(tiny_feature_map, dict(train_params, patience=2), device="cpu")
    assert get_learning_rate(tr.optimizer) == pytest.approx(1e-3)
    assert tr.lr_decay() == pytest.approx(1e-4)
    for _ in range(10):
        lr = tr.lr_decay()
    assert lr == pytest.approx(1e-6)  # the floor
    tr._best_metric, tr._stopping_steps, tr._stop_training = 1.0, 0, False
    tr.checkpoint_and_earlystop(1.0, {"AUC": 0.5})
    assert not tr._stop_training
    tr.checkpoint_and_earlystop(2.0, {"AUC": 0.5})
    assert tr._stop_training


def test_chip_smoke_train_phase_on_cpu(tmp_path):
    vocab = {"user_id": 60, "item_id": 80, "tag_id": 120}
    pool, test = chip_smoke.mltag_arrays(0, 3000, 300, vocab=vocab)
    before = (k1.launches, k2.launches)
    trainer, gen, res = chip_smoke.train("cpu", 0, pool, test, 64, str(tmp_path))
    assert (k1.launches, k2.launches) == before
    assert res["launches"] == {"cross_intra_block": 0, "bm25_topk": 0, "embedding_grad": 0}
    assert res["steps"] == len(gen) == 47 and res["valid_batches"] == 5
    assert res["one_step"]["loss_abs_err"] <= 1e-6
    assert res["one_step"]["grad_max_abs_err"] <= 1e-6
    assert res["last_steps_loss"] < res["first_steps_loss"]
    assert res["AUC"] == pytest.approx(res["best_AUC"], abs=1e-6) and res["AUC"] > 0.55
    assert os.path.exists(trainer.checkpoint)
