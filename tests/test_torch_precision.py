"""The matmul-precision switch of rat_tpu_torch (``RAT_TPU_MATMUL_PRECISION``,
``rat_tpu_torch.set_matmul_precision``) against the JAX package's
``jax_default_matmul_precision``, on the CPU: the mapping of each value
JAX accepts, the refusals, the read at import, and chip_smoke's
``precision`` phase (the JAX gate of tests/test_bf16_gate.py) at a tiny
size, its neighbour caches against rat_tpu's DataGenerator on the same
rows. The CPU's products ignore the setting, so no gate bound is held
here: the card holds it (``python3 chip_smoke.py``)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import rat_tpu_torch
from rat_tpu.data.io import save_hdf5
from rat_tpu.data.loader import DataGenerator as JaxDataGenerator
from rat_tpu.features import FeatureMap as JaxFeatureMap
from tests import test_bf16_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread_float32():
    """One intra-op thread (the suite runs files in parallel workers), and
    the default precision again after each test, in both packages."""
    threads = torch.get_num_threads()
    jax_prev = jax.config.jax_default_matmul_precision
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    rat_tpu_torch.set_matmul_precision("float32")
    jax.config.update("jax_default_matmul_precision", jax_prev)


def _state():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("name,want", [
    ("float32", ("highest", False, False)), ("highest", ("highest", False, False)),
    ("tensorfloat32", ("high", True, False)), ("high", ("high", True, False)),
    ("bfloat16", ("high", True, False)), ("default", ("high", True, False))])
def test_each_jax_value_maps(name, want):
    """Each precision class JAX accepts selects IEEE float32 or TF32 for
    float32 products, cuDNN's TF32 off; JAX takes the same value."""
    rat_tpu_torch.set_matmul_precision("bfloat16" if want[0] == "highest" else "float32")
    rat_tpu_torch.set_matmul_precision(name)
    assert _state() == want
    jax.config.update("jax_default_matmul_precision", name)
    assert rat_tpu_torch.MATMUL_PRECISIONS[name] == want[0]


@pytest.mark.parametrize("name,jax_accepts", [("foo", False), ("BF16_BF16_F32", True)])
def test_other_values_raise_naming_the_variable(name, jax_accepts):
    """An unknown value raises ValueError naming the variable, as JAX
    raises; JAX's dot-algorithm names are refused too (ROADMAP, left out
    on purpose). The setting in force stays."""
    rat_tpu_torch.set_matmul_precision("tensorfloat32")
    with pytest.raises(ValueError, match="RAT_TPU_MATMUL_PRECISION"):
        rat_tpu_torch.set_matmul_precision(name)
    assert _state() == ("high", True, False)
    if jax_accepts:
        jax.config.update("jax_default_matmul_precision", name)
    else:
        with pytest.raises(ValueError):
            jax.config.update("jax_default_matmul_precision", name)


_READ = ("import rat_tpu_torch, torch; print(torch.get_float32_matmul_precision(), "
         "torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)")


@pytest.mark.parametrize("value,want", [(None, "highest False False"),
                                        ("bfloat16", "high True False"),
                                        ("foo", None)])
def test_import_reads_the_variable(value, want):
    """A process importing rat_tpu_torch: unset, float32 (TF32 off, as
    before the switch); bfloat16, TF32; an unknown value, the import
    raises naming the variable."""
    env = {k: v for k, v in os.environ.items() if k != "RAT_TPU_MATMUL_PRECISION"}
    if value is not None:
        env["RAT_TPU_MATMUL_PRECISION"] = value
    out = subprocess.run([sys.executable, "-c", _READ], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(env, PYTHONPATH=REPO))
    if want is None:
        assert out.returncode != 0
        assert "ValueError: RAT_TPU_MATMUL_PRECISION='foo'" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == want.split()


def test_gate_is_the_jax_gate():
    """chip_smoke's copy of the JAX gate: the same rows from the same
    RandomState, vocabularies, topK and bounds."""
    for n in (8192, 7):
        np.testing.assert_array_equal(
            chip_smoke.gate_rows(n, np.random.RandomState(11)),
            test_bf16_gate._synth_rows(n, np.random.RandomState(11)))
    assert chip_smoke.GATE_VOCABS == test_bf16_gate.VOCABS
    assert chip_smoke.GATE_K == test_bf16_gate.K
    assert (chip_smoke.GATE_AUC, chip_smoke.GATE_LOGLOSS) == \
        (test_bf16_gate.AUC_GATE, test_bf16_gate.LOGLOSS_GATE)


def test_precision_phase_on_cpu(tmp_path):
    """The precision phase at 512 / 256 rows, one epoch, the KKBox bench
    step at batch 16: the switch reads each setting, float32 comes back,
    every retrieval call of the fits goes through the phase's K2 check,
    no kernel is launched, both fits give finite metrics and identical
    neighbour caches, and those caches equal rat_tpu's DataGenerator's
    on the same rows (indices, values and lengths exactly). No time is
    read on the CPU."""
    rows = (512, 256)
    res = chip_smoke.precision("cpu", str(tmp_path), rows=rows, epochs=1,
                               bench_shapes=("kkbox",), bench_batch=16, bench_rows=512,
                               steps=1, warmup=0)
    assert _state() == ("highest", False, False)
    assert res["tf32"] == {"float32": False, "bfloat16": True}
    assert res["launches"] == {"cross_intra_block": 0, "bm25_topk": 0,
                               "bm25_score_chunk": 0}
    # 2 fits x (2 folds of 256 queries + the valid split's 256)
    assert res["k2_held_to_plain"] == {256: 6}
    assert res["caches_identical"] == ["train", "valid"]
    assert res["cache_rows"] == {"train": 512, "valid": 256}
    assert res["step_device_ms"] == {"kkbox": {"float32": [None], "bfloat16": [None]}}
    for fit in res["fits"].values():
        assert np.isfinite(fit["AUC"]) and np.isfinite(fit["logloss"])

    rng = np.random.RandomState(11)
    jdir = tmp_path / "jax"
    paths = {split: str(jdir / (split + ".h5")) for split in ("train", "valid")}
    for split, n in zip(paths, rows):
        save_hdf5(chip_smoke.gate_rows(n, rng), paths[split])
    fm = JaxFeatureMap("gate", str(jdir))
    fm.feature_specs.update(
        {name: {"source": "", "type": "categorical", "vocab_size": v, "index": idx}
         for idx, (name, v) in enumerate(chip_smoke.GATE_VOCABS.items())})
    fm.num_fields = fm.input_length = 3
    common = dict(batch_size=1024, shuffle=False, feature_map=fm,
                  retrieval_configs=dict(chip_smoke.GATE_RETRIEVAL),
                  retrieval_augmented=True)
    gens = {"train": JaxDataGenerator(data_path=paths["train"],
                                      retrieval_pool_fname="self", **common),
            "valid": JaxDataGenerator(data_path=paths["valid"],
                                      retrieval_pool_fname=paths["train"], **common)}
    for tag in ("float32", "bfloat16"):
        for split, gen in gens.items():
            with np.load(str(tmp_path / tag / "retrieval_3_{}.npz".format(split))) as z:
                np.testing.assert_array_equal(z["indices"], gen.retr_indices)
                np.testing.assert_array_equal(z["values"], gen.retr_values)
                np.testing.assert_array_equal(z["lens"], gen.retr_lens)
