"""Entry points of the port's benchmark on the CPU: the scaling bench
as the README calls it, ``bench_scaling(2, device="cpu", ...)``, which
spawns two gloo ranks itself and reports correctness only (the mesh's
first loss against one device's on the same global batch, within 1e-5
relative), as the JAX package does on virtual CPU devices; and every
entry point raising without CUDA (``python -m
rat_tpu_torch.cli.benchmark``, ``bench_torch.py``, ``python -m
rat_tpu_torch.ops.bench_kernel``, ``bench_scaling``)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from rat_tpu_torch.cli import benchmark as bm
from rat_tpu_torch.ops import bench_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scaling_on_a_two_rank_gloo_world_reports_correctness_only():
    code = ("import json\n"
            "from rat_tpu_torch.cli.benchmark import bench_scaling\n"
            "print(json.dumps(bench_scaling(2, device='cpu', steps=1, per_device=64, "
            "n_rows=2000)))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "spmd_correctness_2dev"
    assert line["value"] == 1.0 and line["unit"] == "bool"
    assert "efficiency" in line["note"]


def test_scaling_needs_two_ranks():
    with pytest.raises(ValueError, match="at least 2 ranks"):
        bm.bench_scaling(1, device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bm.bench_train(steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bm.bench_retrieval(n_db=10, n_qry=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        bm.bench_scaling(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_kernel.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        bm.main(["--bench", "eval"])
    env = dict(os.environ, PYTHONPATH=REPO, RAT_TPU_BENCH_HEADLINE_ONLY="1")
    env.pop("RAT_TPU_PLATFORM", None)
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not out.stdout.strip()

