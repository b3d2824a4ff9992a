"""The port's CLI on a mesh, on the CPU: ``run_expid_torch.py --mesh 2x1
--gpu -1`` on the demo config starts two gloo workers itself, and its
results line must give the single process's valid and test AUC and
logloss within 1e-3. Rank 0 alone writes the results line. Asking for
more CUDA devices than exist raises."""

import os
import re
import signal
import subprocess
import sys

import pytest

from rat_tpu_torch.cli import run_expid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(work, *extra):
    """Write the demo CSVs and config (2 epochs) into ``work`` and run the
    CLI there; returns the lines of its results CSV."""
    os.makedirs(os.path.join(work, "configs", "demo"))
    from rat_tpu_torch.data.synthetic import make_mltag_like
    make_mltag_like(os.path.join(work, "data", "demo"), n_train=1500, n_valid=300,
                    n_test=300, n_users=40, n_items=30, n_tags=12, seed=3)
    for name in ("dataset_config.yaml", "model_config.yaml"):
        with open(os.path.join(REPO, "configs", "demo", name)) as fh:
            text = fh.read().replace("    epochs: 20\n", "    epochs: 2\n")
        with open(os.path.join(work, "configs", "demo", name), "w") as fh:
            fh.write(text)
    # a session of its own, so that a time-out kills the workers the CLI
    # spawned along with it
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "run_expid_torch.py"), "--config",
         "./configs/demo", "--expid", "RAT_m2_demo_10fold_retrieval", "--gpu", "-1"]
        + list(extra), cwd=work, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    try:
        _, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        raise AssertionError("the CLI ran past 240 s:\n" + err[-3000:])
    assert proc.returncode == 0, err[-3000:]
    with open(os.path.join(work, "exps", "demo", "demo_10fold_retrieval",
                           "RAT_m2_demo_10fold_retrieval.csv")) as fh:
        return fh.read().strip().splitlines()


def _metrics(line):
    return {(split, m): float(v) for split, body in re.findall(r"\[(val|test)\] ([^,]*)",
                                                              line)
            for m, v in re.findall(r"(\w+): ([-\d.e]+)", body)}


def test_mesh_cli_matches_single_process(tmp_path):
    single = _run_cli(str(tmp_path / "single"))
    mesh = _run_cli(str(tmp_path / "mesh"), "--mesh", "2x1")
    assert len(single) == len(mesh) == 1
    want, got = _metrics(single[0]), _metrics(mesh[0])
    assert sorted(got) == sorted(want) and len(want) == 4
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-3, key
    assert "--mesh 2x1" in mesh[0]


def test_too_few_cuda_devices_raise(monkeypatch):
    monkeypatch.setattr(run_expid.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        run_expid._mesh_devices(2, 0)
    assert run_expid._mesh_devices(2, -1) == ["cpu", "cpu"]


def test_platform_maps_onto_the_device(monkeypatch):
    monkeypatch.delenv("RAT_TPU_PLATFORM", raising=False)
    assert run_expid._platform_gpu(3, "auto") == 3
    assert run_expid._platform_gpu(3, "cpu") == -1
    assert run_expid._platform_gpu(-1, "gpu") == 0
    monkeypatch.setenv("RAT_TPU_PLATFORM", "cpu")
    assert run_expid._platform_gpu(0, "auto") == -1
