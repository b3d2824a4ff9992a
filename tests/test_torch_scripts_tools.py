"""The port's run scripts other than the Tmall rehearsal
(rat_tpu_torch.scripts) on the CPU:

- stall_guard: the three cases of tests/test_stall_guard.py, run as
  ``python -m rat_tpu_torch.scripts.stall_guard``;
- gm_encoder_ab.encoder_gm against the JAX script's ``encoder_gm``
  (scripts/gm_encoder_ab.py) on the same flax parameters, carried by
  ``convert.params_from_jax``, at b=8 and depth 2: forward within rtol
  1e-5 / atol 1e-6, gradients of ``sum(out ** 2)`` within rtol 1e-4 /
  atol 1e-5; and against the port's module encoder with the same
  tolerances;
- dedup_ab's collective profile on a gloo world of 2 ranks (1 data x 2
  model): the model group's all-reduce is recorded, and the first-step
  losses with dedup off and on agree within 1e-6, as the dry run
  asserts;
- tax_probe, degraded_ab and profile_train_step at a tiny size: their
  lines print with the JAX scripts' case names and fields;
- every script but stall_guard raises without a card unless the CPU was
  asked for;
- ``parallel.dryrun.entry``'s forward against ``__graft_entry__.entry``'s
  on the same parameters (rtol 1e-5 / atol 1e-6).
"""

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rat_tpu.nn.encoders import CrossIntraEncoder as JaxCrossIntraEncoder
from rat_tpu_torch.convert import params_from_jax
from rat_tpu_torch.nn.encoders import CrossIntraEncoder
from rat_tpu_torch.parallel.dryrun import entry
from rat_tpu_torch.scripts import (degraded_ab, gm_encoder_ab, profile_train_step,
                                   script_device, tax_probe)
from torch_mesh_world import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# scripts/tax_probe.py's case names, in its order
TAX_CASES = ["ew_grid      [6,4,10,4096]", "ew_flat      [983040]", "layernorm    axis=d",
             "qkv+out_proj reduces", "attention    core fwd", "transpose_rt b<->major",
             "gather+redux 73728xd", "scatter_add  73728xd"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- stall_guard -----------------------------------------------------------

def _run_guard(tmp_path, child_code, stall=6.0, poll=0.5, max_restarts=2,
               timeout=120):
    # stall must comfortably exceed the child interpreter's startup, or a
    # healthy child gets killed while booting
    child = tmp_path / "child.py"
    child.write_text(child_code)
    progress = tmp_path / "progress.txt"
    out = subprocess.run(
        [sys.executable, "-m", "rat_tpu_torch.scripts.stall_guard",
         "--stall-secs", str(stall), "--poll-secs", str(poll),
         "--max-restarts", str(max_restarts), "--watch", str(progress), "--",
         sys.executable, str(child), str(progress)],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    return out, progress


def test_stall_guard_healthy_child_passes_through(tmp_path):
    code = (
        "import sys, time\n"
        "p = sys.argv[1]\n"
        "for i in range(6):\n"
        "    open(p, 'a').write('tick %d\\n' % i)\n"
        "    time.sleep(0.5)\n"
    )
    out, _ = _run_guard(tmp_path, code)
    assert out.returncode == 0, out.stderr
    assert "killing" not in out.stderr


def test_stall_guard_restarts_a_stalled_child_to_success(tmp_path):
    # the first run stalls after one tick; on the restart the child sees
    # its marker file and finishes at once: the guard must converge
    code = (
        "import os, sys, time\n"
        "p = sys.argv[1]\n"
        "marker = p + '.second_run'\n"
        "open(p, 'a').write('tick\\n')\n"
        "if os.path.exists(marker):\n"
        "    sys.exit(0)\n"
        "open(marker, 'w').write('x')\n"
        "time.sleep(3600)\n"
    )
    out, _ = _run_guard(tmp_path, code)
    assert out.returncode == 0, out.stderr
    assert "killing" in out.stderr
    assert "restart 1" in out.stderr


def test_stall_guard_gives_up_after_max_restarts(tmp_path):
    out, _ = _run_guard(tmp_path, "import sys; sys.exit(3)\n", max_restarts=1)
    assert out.returncode == 3
    assert "giving up" in out.stderr


# ---- gm_encoder_ab ---------------------------------------------------------

def _jax_gm_script():
    spec = importlib.util.spec_from_file_location(
        "jax_gm_encoder_ab", os.path.join(REPO, "scripts", "gm_encoder_ab.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _strip(state):
    return {k[len("encoder."):]: v for k, v in state.items()}


def test_encoder_gm_matches_jax_and_the_module_encoder():
    b, t, s, d, heads, dim_head, depth, hidden = 8, 6, 4, 10, 2, 10, 2, 40
    jgm = _jax_gm_script()
    jenc = JaxCrossIntraEncoder(d, heads, dim_head, 0.0, depth, hidden)
    x = np.random.RandomState(0).randn(b, t, s, d).astype(np.float32)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p, xx):
        return jnp.sum(jgm.encoder_gm(p, xx, heads, dim_head, depth) ** 2)

    want = np.asarray(jgm.encoder_gm(params, jnp.asarray(x), heads, dim_head, depth))
    jgrads = _strip(params_from_jax(
        {"encoder": jax.device_get(jax.jit(jax.grad(jloss))(params, jnp.asarray(x)))}))

    state = {k: v.requires_grad_() for k, v in
             _strip(params_from_jax({"encoder": jax.device_get(params)})).items()}
    got = gm_encoder_ab.encoder_gm(state, torch.from_numpy(x), heads, dim_head, depth)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    (got ** 2).sum().backward()
    assert set(state) == set(jgrads)
    for name, p in state.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)

    module = CrossIntraEncoder(d, heads, dim_head, depth, hidden)
    module.load_state_dict({k: v.detach() for k, v in state.items()})
    xt = torch.from_numpy(x)
    out = module(xt)
    np.testing.assert_allclose(got.detach().numpy(), out.detach().numpy(), **FWD_TOL)
    (out ** 2).sum().backward()
    for name, p in module.named_parameters():
        np.testing.assert_allclose(state[name].grad.numpy(), p.grad.numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_gm_encoder_ab_prints_the_jax_keys(capsys):
    res = gm_encoder_ab.main(["--b", "8", "--depth", "2", "--trials", "2", "--parity",
                              "--platform", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert set(line) == {"shape", "depth", "fwd_max_abs_err", "grad_max_abs_err",
                         "ref_ms", "gm_ms", "speedup"}
    assert line["shape"] == [8, 6, 4, 10]
    assert line["fwd_max_abs_err"] < 1e-5 and line["grad_max_abs_err"] < 1e-5


# ---- dedup_ab --------------------------------------------------------------

_DEDUP_WORLD = """
import json
from rat_tpu_torch.scripts.dedup_ab import collective_profile
mesh = make_mesh(2, 2)
off, loss_off, calls = collective_profile(mesh, False)
on, loss_on, _ = collective_profile(mesh, True)
model_all_reduces = [n for kind, group, n in calls
                     if kind == "all-reduce" and group is mesh.model_group]
print(json.dumps({"off": off, "on": on, "loss_off": loss_off, "loss_on": loss_on,
                  "model_all_reduces": model_all_reduces}))
"""


def test_dedup_collective_profile_on_two_ranks(tmp_path):
    outs = run_world(_DEDUP_WORLD, 2, str(tmp_path), timeout=150)
    for out in outs:
        res = json.loads(out.strip().splitlines()[-1])
        assert res["model_all_reduces"] and all(n > 0 for n in res["model_all_reduces"])
        assert res["off"]["collectives"]["all-reduce"] >= len(res["model_all_reduces"])
        assert np.isfinite(res["loss_off"])
        assert abs(res["loss_off"] - res["loss_on"]) < 1e-6


# ---- the tools' lines ------------------------------------------------------

def test_tax_probe_prints_the_jax_cases(capsys):
    out = tax_probe.main([], device="cpu", b=16, reps=(1, 3))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["case", "us/op", "(marginal,", "3", "vs", "1", "reps)"]
    assert list(out) == TAX_CASES
    for line, name in zip(lines[1:], TAX_CASES):
        assert line.startswith(name)
        float(line[len(name):])


def test_degraded_ab_prints_the_jax_line(capsys, monkeypatch):
    monkeypatch.setenv("RAT_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("RAT_AB_OVERRIDE", json.dumps({"depth": 1}))
    degraded_ab.main(["32", "2", "4"], n_rows=1000)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"B=32 group=2 impl=\S+ xla_flags='.*' compile=[\d.]+s "
                        r"rates=\['\d+k', '\d+k', '\d+k'\] best=\d+k ex/s "
                        r"\([\d.]+ ms/step\)", line), line


def test_profile_train_step_prints_a_kernel_table(capsys):
    ranked, total = profile_train_step.main(["mltag", "2", "grid_minor"], device="cpu",
                                            batch_size=32, n_rows=1000)
    lines = capsys.readouterr().out.strip().splitlines()
    assert "ignored" in lines[0]
    assert "total accounted" in lines[1] and total > 0
    rows = lines[2:]
    assert len(rows) == min(45, len(ranked)) > 0
    for row in rows:
        assert re.match(r"^ +[\d.]+ us +[\d.]+%  \S", row), row


# ---- devices ---------------------------------------------------------------

SCRIPTS = ["chip_health", "dedup_ab", "degraded_ab", "gm_encoder_ab",
           "profile_train_step", "tax_probe", "tmall_rehearsal", "tmall_rehearsal_tail"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_raises_without_a_card(name, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    monkeypatch.delenv("RAT_TPU_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module("rat_tpu_torch.scripts." + name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
    assert os.listdir(tmp_path) == []


def test_script_device_reads_the_platform_variable(monkeypatch):
    monkeypatch.setenv("RAT_TPU_PLATFORM", "cpu")
    assert script_device() == torch.device("cpu")
    assert script_device("cpu") == torch.device("cpu")


# ---- the flagship forward (__graft_entry__.entry) --------------------------

def test_entry_forward_matches_graft_entry():
    jforward, (jparams, jX, jy) = graft.entry()
    want = np.asarray(jforward(jparams, jX, jy))
    forward, (model, X, y) = entry(device="cpu")
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    with torch.no_grad():
        got = forward(model, X, y).numpy()
    assert got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got, want, **FWD_TOL)
