"""The slice as a whole: the port's experiment entry point
(rat_tpu_torch/cli/run_expid.py) against the JAX package's, CSV to
results line, on the CPU.

``RAT_m2_demo_10fold_retrieval`` runs from the same small ML-Tag-shaped
CSVs through ``rat_tpu.cli.run_expid.run_experiment`` and the port's
``run_experiment(..., gpu=-1)``, each in its own working directory with
a copy of configs/demo set to two epochs. The port's Trainer starts from
the JAX Trainer's initial weights (``convert.params_from_jax``), handed
over by patching the name each CLI builds its Trainer from. Tolerances
are those of the fit-trajectory test (tests/test_torch_train.py): each
epoch's train loss within atol 2e-4, each evaluation's metrics within
1e-3, the final learning rate within rtol 1e-6. Then a rerun reuses the
caches, and chip_smoke's cli phase runs at a tiny size."""

import os
import re
import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

import chip_smoke
import rat_tpu.cli.run_expid as jax_cli
import rat_tpu_torch.cli.run_expid as cli
import rat_tpu_torch.data.loader as loader
from rat_tpu.data.synthetic import make_mltag_like
from rat_tpu.engine.optim import get_learning_rate as jax_get_lr
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.engine.optim import get_learning_rate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPID = "RAT_m2_demo_10fold_retrieval"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host. For the whole module, so
    that its module fixtures run on one thread too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)


def _workdir(root):
    """A working directory with the demo CSVs and a two-epoch copy of
    configs/demo."""
    os.makedirs(root)
    make_mltag_like(os.path.join(root, "data", "demo"), n_train=3000, n_valid=600,
                    n_test=600, n_users=80, n_items=50, n_tags=20, seed=1)
    config = os.path.join(root, "configs", "demo")
    shutil.copytree(os.path.join(REPO, "configs", "demo"), config)
    path = os.path.join(config, "model_config.yaml")
    with open(path) as fh:
        text = fh.read()
    assert text.count("    epochs: 20\n") == 1
    with open(path, "w") as fh:
        fh.write(text.replace("    epochs: 20\n", "    epochs: 2\n"))
    return "./configs/demo"


def _results_line(root):
    with open(os.path.join(root, "exps", "demo", "demo_10fold_retrieval",
                           EXPID + ".csv")) as fh:
        return fh.read().splitlines()


def _fields(line):
    """{field name: value} of a results line, without its timestamp and
    command."""
    return dict(re.findall(r"\[(\w+)\] ([^,]*)", line))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX record, port record, port and JAX working dirs, the initial
    weights): each record holds the per-epoch losses, every
    evaluation's metrics, the valid/test results and the final learning
    rate."""
    base = tmp_path_factory.mktemp("cli")
    jroot, troot = str(base / "jax"), str(base / "torch")
    jcfg, tcfg = _workdir(jroot), _workdir(troot)
    rec = {"jax": {"losses": [], "evals": []}, "torch": {"losses": [], "evals": []}}

    def recording(cls, name):
        class Recording(cls):
            def train_one_epoch(self, gen, epoch):
                out = super().train_one_epoch(gen, epoch)
                rec[name]["losses"].append(float(out[0]))
                return out

            def evaluate(self, gen, data=None):
                logs = super().evaluate(gen, data)
                rec[name]["evals"].append(dict(logs))
                rec[name]["trainer"] = self
                return logs
        return Recording

    class JaxTrainer(recording(jax_cli.Trainer, "jax")):
        def init_state(self, *a, **k):
            out = super().init_state(*a, **k)
            rec["init"] = jax.device_get(self.state.params)
            return out

    class TorchTrainer(recording(cli.Trainer, "torch")):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.model.load_state_dict(params_from_jax(rec["init"]))

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_cli, "Trainer", JaxTrainer)
        mp.setattr(cli, "Trainer", TorchTrainer)
        mp.chdir(jroot)
        rec["jax"]["results"] = jax_cli.run_experiment(jcfg, EXPID)
        rec["jax"]["lr"] = jax_get_lr(rec["jax"]["trainer"].state.opt_state)
        mp.chdir(troot)
        rec["torch"]["results"] = cli.run_experiment(tcfg, EXPID, gpu=-1)
        rec["torch"]["lr"] = get_learning_rate(rec["torch"]["trainer"].optimizer)
    finally:
        mp.undo()
    return rec["jax"], rec["torch"], troot, jroot, rec["init"]


def test_cli_run_matches_jax(runs):
    jrec, rec, troot, jroot, _ = runs
    assert len(rec["losses"]) == len(jrec["losses"]) == 2
    np.testing.assert_allclose(rec["losses"], jrec["losses"], rtol=0, atol=2e-4)
    # two evaluations in the fit, then the reloaded valid and the test
    assert len(rec["evals"]) == len(jrec["evals"]) == 4
    for ours, theirs in zip(rec["evals"], jrec["evals"]):
        for k in ("AUC", "logloss"):
            assert abs(ours[k] - theirs[k]) < 1e-3, (rec["evals"], jrec["evals"])
    for ours, theirs in zip(rec["results"], jrec["results"]):
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert abs(ours[k] - theirs[k]) < 1e-3
    assert np.isclose(rec["lr"], jrec["lr"], rtol=1e-6)
    (line,), (jline,) = _results_line(troot), _results_line(jroot)
    fields, jfields = _fields(line), _fields(jline)
    assert fields.keys() == jfields.keys() == {"command", "exp_id", "dataset_id",
                                               "train", "val", "test"}
    for k in ("exp_id", "dataset_id", "train"):
        assert fields[k] == jfields[k]
    for k in ("val", "test"):
        assert re.sub(r"[0-9.]+", "x", fields[k]) == re.sub(r"[0-9.]+", "x", jfields[k])


def test_cli_build_and_retrieval_match_jax(runs):
    """The port's .npy splits and .npz caches hold the JAX package's
    .h5 splits and caches."""
    _, _, troot, jroot, _ = runs
    tdir = os.path.join(troot, "data", "demo_10fold_retrieval")
    jdir = os.path.join(jroot, "data", "demo_10fold_retrieval")
    with open(os.path.join(tdir, "feature_map.json"), "rb") as a, \
            open(os.path.join(jdir, "feature_map.json"), "rb") as b:
        assert a.read() == b.read()
    for split in ("train", "valid", "test"):
        with h5py.File(os.path.join(jdir, split + ".h5"), "r") as hf:
            assert np.array_equal(np.load(os.path.join(tdir, split + ".npy")), hf["data"][()])
        with np.load(os.path.join(tdir, "retrieval_5_{}.npz".format(split))) as z, \
                h5py.File(os.path.join(jdir, "retrieval_5_{}.h5".format(split)), "r") as hf:
            for key in ("indices", "values", "lens"):
                np.testing.assert_array_equal(z[key], hf[key][()], err_msg=key)


def test_cli_rerun_reuses_the_build_and_caches(runs, monkeypatch):
    _, rec, troot, _, init = runs

    def refuse(*a, **k):
        raise AssertionError("the rerun must not build or retrieve")

    class SameInit(cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.model.load_state_dict(params_from_jax(init))

    monkeypatch.setattr(cli, "Trainer", SameInit)
    monkeypatch.setattr(cli, "build_dataset", refuse)
    monkeypatch.setattr(loader, "bm25_topk_retrieval", refuse)
    monkeypatch.chdir(troot)
    valid, test = cli.run_experiment("./configs/demo", EXPID, gpu=-1)
    # torch's multithreaded CPU kernels may sum in another order from
    # run to run (float32 noise of ~1e-8 in the metrics); chip_smoke's
    # cli phase holds a single-threaded CPU rerun, and the card's, to
    # the same results line exactly
    for ours, first in zip((valid, test), rec["results"]):
        assert ours.keys() == first.keys()
        for k in ours:
            assert abs(ours[k] - first[k]) < 1e-6, (ours, first)
    assert len(_results_line(troot)) == 2


def test_cli_without_cuda_raises_for_a_gpu_index(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run_experiment("./no/such/config", EXPID, gpu=0)


def test_chip_smoke_cli_phase_on_cpu(tmp_path):
    res = chip_smoke.cli("cpu", 0, str(tmp_path), rows=(2000, 500, 300),
                         ids={"n_users": 50, "n_items": 70, "n_tags": 90})
    assert res["launches"] == res["rerun_launches"] == {
        "cross_intra_block": 0, "bm25_topk": 0, "bm25_score_chunk": 0}
    assert res["vocab"] == {"user_id": 51, "item_id": 71, "tag_id": 91}
    assert res["epochs"] == 2 and res["neighbours_checked"] == 200
    assert "[val] AUC: " in res["results_line"]
