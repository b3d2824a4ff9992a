"""The port's benchmark harness (rat_tpu_torch/cli/benchmark.py,
bench_torch.py, ops/bench_kernel.py) against the JAX package's
(rat_tpu/cli/benchmark.py), on the CPU.

The workload tables are the JAX package's; the bench's arrays, drawn
from RandomState(0), are equal to those the JAX ``_bench_setup`` draws
(its Trainer replaced by a recorder, so that no JAX model is built
there); one fused-path train step at batch 64 on the ML-Tag shape, from
JAX weights converted by ``params_from_jax``, gives the loss of the JAX
package's train step (its ``_train_core`` loss from the JAX package's
own functions: gather, fused forward on its plain path, BCE, the
regularizer) within rtol 1e-5. Every bench's line has the JAX names and
keys at tiny sizes; ``--suite`` exits non-zero when a bench raises;
RAT_AB_OVERRIDE is stamped; and chip_smoke's bench phase runs at a tiny
size. No timing is asserted. (The scaling bench's gloo world and the
entry points without CUDA: tests/test_torch_bench_entry.py.)"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rat_tpu.cli.benchmark as jbm
import rat_tpu.engine
from rat_tpu.engine.optim import regularization_loss as jax_reg
from rat_tpu.engine.trainer import _bce as jax_bce
from rat_tpu.engine.trainer import _gather_batch as jax_gather
from rat_tpu.models import build_model as jax_build_model
from rat_tpu.models.fast_forward import rat_m2_fast_forward as jax_fast
from rat_tpu_torch.cli import benchmark as bm
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.ops import bm25_topk as k2
from rat_tpu_torch.ops import cross_intra_block as k1

TINY = dict(batch_size=64, n_rows=1500, device="cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the Tmall shape's Adam step over 18.6M parameters on every core of
    each worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_workload_tables_equal_jax():
    assert bm.SHAPES == jbm.SHAPES
    assert bm.REF == jbm.REF


class _Recorder:
    """Stands in for the JAX Trainer inside ``_bench_setup``: records the
    feature map and params, builds nothing."""

    def __init__(self, fm, params):
        self.fm, self.params = fm, params

    def init_state(self, *args):
        pass

    def _build_steps(self):
        pass


@pytest.fixture()
def jax_setup(monkeypatch):
    """JAX's _bench_setup on the ML-Tag shape, fused path, batch 64, two
    index batches, with its Trainer recorded: (recorder, arrays, idx)."""
    monkeypatch.setattr(rat_tpu.engine, "Trainer", _Recorder)
    rec, data, idx, B = jbm._bench_setup("mltag", True, 64, n_idx=2)
    assert B == 64
    return rec, {k: np.asarray(v) for k, v in data.items()}, [np.asarray(i) for i in idx]


@pytest.mark.parametrize("shape", ["mltag", "kkbox", "tmall"])
def test_bench_arrays_and_params_equal_jax(shape, monkeypatch):
    monkeypatch.setattr(rat_tpu.engine, "Trainer", _Recorder)
    rec, data, idx, _ = jbm._bench_setup(shape, False, 32, n_idx=3)
    tokens, labels, nbr, pidx = bm.bench_arrays(shape, 32, 3)
    np.testing.assert_array_equal(tokens, np.asarray(data["tokens"]))
    np.testing.assert_array_equal(labels, np.asarray(data["labels"]))
    np.testing.assert_array_equal(nbr, np.asarray(data["nbr"]))
    for a, b in zip(pidx, idx):
        np.testing.assert_array_equal(a, np.asarray(b))
    params = bm.bench_params(shape, False, 32)
    assert {k: v for k, v in params.items() if k != "model_root"} == \
        {k: v for k, v in rec.params.items() if k != "model_root"}
    fm = bm._bench_feature_map(shape)
    assert fm.feature_specs == rec.fm.feature_specs
    assert (fm.num_fields, fm.num_features, fm.input_length) == \
        (rec.fm.num_fields, rec.fm.num_features, rec.fm.input_length)


def test_fused_train_step_loss_matches_jax(jax_setup):
    """rtol 1e-5 on the loss: float32 sums over 64 rows and the
    regularizer's table norms, in two frameworks."""
    rec, jdata, jidx = jax_setup
    model = jax_build_model(rec.fm, rec.params)
    B, K, F = 64, 5, 3
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, X, y: model.init({"params": r, "dropout": r}, X, y, None,
                                                   train=False))(
        key, np.zeros((2, 1 + K, F), np.int32), np.zeros((2, 1 + K), np.float32))
    jparams = variables["params"]
    p = rec.params

    def loss_fn(params, data, idx):
        X, y, Xf, _ = jax_gather(data, idx)
        out = jax_fast(params, model, X, y, Xf)
        pred, target = out["y_pred"][:, 0], out["y_true"][:, 0]
        loss = jnp.sum(jax_bce(pred, target)) / np.float32(B)
        return loss + jax_reg(params, p["embedding_regularizer"], p["net_regularizer"])

    want = float(jax.jit(loss_fn)(jparams, jdata, jnp.asarray(jidx[0])))
    trainer, data, idx, _ = bm._bench_setup("mltag", True, 64, n_idx=2, device="cpu")
    trainer.model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    got = float(trainer.train_step(data, idx[0], B))
    assert got == pytest.approx(want, rel=1e-5)


def _keys(line):
    return set(line) - {"ab_override", "note"}


def test_every_bench_line_has_the_jax_names_at_a_tiny_size():
    """The KKBox and Tmall train lines come from chip_smoke's bench phase
    below."""
    lines = [bm.bench_train(False, steps=2, warmup=1, **TINY),
             bm.bench_train(True, steps=2, warmup=1, **TINY),
             bm.bench_eval(steps=2, **TINY),
             bm.bench_retrieval(n_db=1500, n_qry=2500, device="cpu"),
             bm.bench_retrieval_exm(n_db=1500, n_qry=2500, device="cpu")]
    names = ["rat_m2_mltag_train_throughput", "rat_m2_mltag_train_throughput_pallas",
             "rat_m2_mltag_eval_throughput", "bm25_retrieval_queries_per_s_200k_pool",
             "bm25_exact_match_queries_per_s_200k_pool"]
    assert [line["metric"] for line in lines] == names
    for line in lines:
        assert _keys(line) == {"metric", "value", "unit", "vs_baseline"}
        assert line["value"] > 0
        json.dumps(line)
    assert lines[0]["unit"] == "examples/s" and lines[3]["unit"] == "queries/s"
    # the exact-match line carries no baseline of another accelerator
    assert lines[-1]["vs_baseline"] is None and "no baseline" in lines[-1]["note"]
    assert lines[0]["vs_baseline"] == round(lines[0]["value"] / 5.4e4, 3)


def test_ab_override_is_stamped_and_applied(monkeypatch):
    monkeypatch.setenv("RAT_AB_OVERRIDE", json.dumps({"depth": 1}))
    assert bm.bench_params("mltag")["depth"] == 1
    line = bm.bench_train(False, steps=1, warmup=0, **TINY)
    assert line["ab_override"] == json.dumps({"depth": 1})
    monkeypatch.delenv("RAT_AB_OVERRIDE")
    assert "ab_override" not in bm.bench_eval(steps=1, **TINY)


def test_suite_prints_an_error_line_and_exits_non_zero(monkeypatch, capsys):
    def fine(*args, **kwargs):
        return {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0}

    def broken(*args, **kwargs):
        raise RuntimeError("no card")

    for name in ("bench_train", "bench_eval", "bench_retrieval", "bench_scaling"):
        monkeypatch.setattr(bm, name, fine)
    monkeypatch.setattr(bm, "bench_retrieval_exm", broken)
    assert bm.main(["--bench", "suite"]) == 1
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 6
    assert lines[4] == {"metric": "retrieval_exm", "error": "no card"}
    monkeypatch.setattr(bm, "bench_retrieval_exm", fine)
    assert bm.main(["--bench", "suite"]) == 0


def test_suite_scales_over_every_card_and_skips_below_two(monkeypatch, capsys):
    def fine(*args, **kwargs):
        return {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0}

    ranks = []
    for name in ("bench_train", "bench_eval", "bench_retrieval", "bench_retrieval_exm"):
        monkeypatch.setattr(bm, name, fine)
    monkeypatch.setattr(bm, "bench_scaling", lambda n, **kw: ranks.append(n) or fine())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert bm.main(["--bench", "suite"]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["metric"] == "scaling" and "at least 2 cards, 1 present" in last["skipped"]
    assert ranks == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert bm.main(["--bench", "suite"]) == 0
    assert bm.main(["--bench", "suite", "--devices", "2"]) == 0
    monkeypatch.setenv("RAT_TPU_PLATFORM", "cpu")
    assert bm.main(["--bench", "scaling"]) == 0
    assert ranks == [4, 2, 2]


def test_chip_smoke_bench_phase_on_cpu():
    """The phase's in-process benches at a tiny size; on the CPU no
    kernel launches and the subprocesses (bench_torch.py, bench_kernel)
    are the card's only."""
    steps = {shape: {"warmup": 1, "steps": 1} for shape in ("mltag", "kkbox", "tmall")}
    k1.launches = k2.launches = 0
    lines, launches, compared = chip_smoke.bench("cpu", batch_size=32, n_rows=1000,
                                                 steps=steps, eval_steps=2,
                                                 retrieval_rows=(1000, 2100))
    assert len(lines) == 7 and all(line["value"] > 0 for line in lines.values())
    assert lines["train kkbox"]["metric"] == "rat_m2_kkbox_train_throughput"
    assert lines["train tmall"]["metric"] == "rat_m2_tmall_train_throughput"
    assert all(_keys(line) == {"metric", "value", "unit", "vs_baseline", "seconds"}
               for line in lines.values())
    assert launches == {"cross_intra_block": 0, "bm25_topk": 0, "bm25_score_chunk": 0}
    # every scan of the retrieval bench's arrays, the 52-query tail too
    assert compared == {2048: 1, 52: 1}
