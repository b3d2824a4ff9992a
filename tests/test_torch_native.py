"""The port's native host encoder (rat_tpu_torch/native) and its hooks
in rat_tpu_torch/features/preprocess.py, on the CPU.

The port's extension is held, output for output, against the JAX
package's (rat_tpu/native/fastenc.cpp, compiled here by the JAX
package's own g++ command into the test's directory and loaded by its
path, so as not to race the JAX package's tests, which build it in
place) and against the port's Python encoders (the threshold raised):
``encode_category`` with OOV values, float and int vocabularies that
never take the string path, ``encode_sequences`` with pre and post
padding and truncation, ``count_tokens``, and the fit of a sequence
column above the native threshold, which without the extension counts
in one pass in this process. Equality is exact. The
extension lands under build/native/ and is never the module that a
bare ``import fastenc`` would find. Then the CLI's build stage split
and its host-encoder line, and chip_smoke's native phase at a tiny
size."""

import importlib.machinery
import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

import chip_smoke
import rat_tpu_torch.features.preprocess as pp
from rat_tpu_torch import native
from rat_tpu_torch.data.synthetic import make_kkbox_like
from rat_tpu_torch.features import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_ext():
    assert native.build(), "the port's extension must build where g++ and Python.h are"
    return native.fastenc


@pytest.fixture(scope="module")
def jax_ext(tmp_path_factory):
    """The JAX package's extension, built from its source with its own
    command (rat_tpu/native/__init__.py::build) into a directory of this
    test, loaded under a name of its own."""
    src = os.path.join(REPO, "rat_tpu", "native", "fastenc.cpp")
    out = str(tmp_path_factory.mktemp("jax_fastenc") / (
        "fastenc" + sysconfig.get_config_var("EXT_SUFFIX")))
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-I" + sysconfig.get_paths()["include"], src, "-o", out], check=True)
    loader = importlib.machinery.ExtensionFileLoader("jax_reference.fastenc", out)
    module = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location("jax_reference.fastenc", out, loader=loader))
    loader.exec_module(module)
    return module


def _python(monkeypatch):
    monkeypatch.setattr(pp, "_NATIVE_MIN_ROWS", 10 ** 12)


def _native(monkeypatch):
    monkeypatch.setattr(pp, "_NATIVE_MIN_ROWS", 0)


def _ran(monkeypatch, fn, use_native):
    (_native if use_native else _python)(monkeypatch)
    pp.reset_encoders_run()
    return fn(), pp.encoders_run()


def test_extension_lives_under_build_native_and_is_not_a_bare_fastenc(
        port_ext, jax_ext, monkeypatch):
    assert native.library_path().startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert os.path.exists(native.library_path())
    assert port_ext.__file__ == native.library_path()
    # the trap of a sys.path import: another module named fastenc already
    # loaded must not be what the port loads
    monkeypatch.setitem(sys.modules, "fastenc", jax_ext)
    monkeypatch.setattr(native, "fastenc", None)
    assert native.build()
    assert native.fastenc is not sys.modules["fastenc"]
    assert native.fastenc.__file__ == native.library_path()
    assert sys.modules[native.MODULE_NAME] is native.fastenc


def test_encode_category_with_oov_matches_jax_and_python(port_ext, jax_ext, monkeypatch):
    rng = np.random.RandomState(0)
    tok = Tokenizer(min_freq=2)
    tok.fit_on_texts(np.array(["v{}".format(i) for i in rng.randint(0, 50, 3000)],
                              dtype=object))
    queries = np.array(["v{}".format(i) for i in rng.randint(0, 80, 5000)] + ["", "é"],
                       dtype=object)
    py, ran_py = _ran(monkeypatch, lambda: tok.encode_category(queries), False)
    nat, ran_nat = _ran(monkeypatch, lambda: tok.encode_category(queries), True)
    assert (ran_py, ran_nat) == ({"category": "python"}, {"category": "native"})
    assert py.dtype == nat.dtype == np.int64
    np.testing.assert_array_equal(py, nat)
    assert (nat == 0).any() and (nat != 0).any()
    assert port_ext.encode_category(list(queries), tok.vocab, 0) == \
        jax_ext.encode_category(list(queries), tok.vocab, 0)


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_non_string_vocabularies_never_take_the_string_path(port_ext, monkeypatch, dtype):
    """ML-Tag's ids are floats: stringified keys ('5.0' against '5')
    would turn values OOV, so only string vocabularies go native."""
    rng = np.random.RandomState(1)
    tok = Tokenizer()
    tok.fit_on_texts(rng.randint(0, 30, 2000).astype(dtype))
    queries = rng.randint(0, 40, 500).astype(np.float64)     # dtype drift too
    out, ran = _ran(monkeypatch, lambda: tok.encode_category(queries), True)
    assert ran == {"category": "python"}
    np.testing.assert_array_equal(out, [tok.vocab.get(q, 0) for q in queries.tolist()])
    assert (out != 0).any()


def _texts(rng, n, vocab=40, longest=6):
    texts = ["|".join("t{}".format(i) for i in rng.randint(0, vocab, rng.randint(0, longest)))
             for _ in range(n)]
    texts[:3] = ["", None, float("nan")]
    return np.array(texts, dtype=object)


@pytest.mark.parametrize("padding,max_len", [("pre", 3), ("post", 4), ("post", 0)])
def test_encode_sequences_match_jax_and_python(port_ext, jax_ext, monkeypatch, padding,
                                               max_len):
    rng = np.random.RandomState(2)
    fit_texts = _texts(rng, 2000)
    texts = _texts(rng, 1500, vocab=60)
    outs = {}
    for use_native in (False, True):
        tok = Tokenizer(splitter="|", max_len=max_len, padding=padding, na_value="")
        (_native if use_native else _python)(monkeypatch)
        pp.reset_encoders_run()
        tok.fit_on_texts(np.where(pp.is_missing(fit_texts), "", fit_texts), use_padding=True)
        outs[use_native] = (tok.encode_sequence(texts), dict(tok.vocab), tok.max_len,
                            pp.encoders_run())
    (py, vocab, longest, ran_py), (nat, vocab_n, longest_n, ran_nat) = outs[False], outs[True]
    assert ran_py == {"count_tokens": "python", "sequence": "python"}
    assert ran_nat == {"count_tokens": "native", "sequence": "native"}
    assert vocab == vocab_n and longest == longest_n
    assert py.dtype == nat.dtype == np.int32 and py.shape == nat.shape == (1500, longest)
    np.testing.assert_array_equal(py, nat)
    cells = pp._clean_text_cells(texts)
    pre = padding == "pre"
    assert port_ext.encode_sequences(cells, vocab, 0, "|", longest, len(vocab) - 1, pre,
                                     pre) == \
        jax_ext.encode_sequences(cells, vocab, 0, "|", longest, len(vocab) - 1, pre, pre)


def test_count_tokens_matches_jax_and_python(port_ext, jax_ext):
    rng = np.random.RandomState(3)
    texts = pp._clean_text_cells(_texts(rng, 3000, vocab=500, longest=9))
    py_counts, py_longest = pp.count_tokens(texts, "|")
    nat_counts, nat_longest = port_ext.count_tokens(texts, "|")
    assert (nat_counts, nat_longest) == jax_ext.count_tokens(texts, "|")
    assert nat_counts == dict(py_counts) and nat_longest == py_longest


def test_long_sequence_column_fits_in_one_pass_like_the_extension(port_ext, monkeypatch):
    """A sequence column above the native threshold: the Python fallback
    counts it in one pass and fits the vocabulary and max_len the
    extension fits."""
    rng = np.random.RandomState(4)
    words = np.array(["w{}".format(i) for i in range(300)], dtype=object)
    lens = rng.randint(1, 5, pp._NATIVE_MIN_ROWS + 1000)
    flat = words[rng.randint(0, 300, lens.sum())]
    texts = np.array([" ".join(r) for r in np.split(flat, np.cumsum(lens)[:-1])],
                     dtype=object)
    fits = {}
    for use_native in (True, False):
        tok = Tokenizer(splitter=" ")
        _, ran = _ran(monkeypatch, lambda: tok.fit_on_texts(texts, use_padding=True),
                      use_native)
        assert ran == {"count_tokens": "native" if use_native else "python"}
        fits[use_native] = tok
    assert fits[False].vocab == fits[True].vocab
    assert fits[False].max_len == fits[True].max_len == 4


def test_a_failed_build_warns_once_and_the_python_path_runs(monkeypatch, caplog, tmp_path):
    monkeypatch.setattr(native, "fastenc", None)
    monkeypatch.setattr(native, "_failed", [])
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "broken.cpp"))
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with caplog.at_level(logging.WARNING):
        assert not native.build() and not native.build()
    assert len([r for r in caplog.records if "did not build" in r.message]) == 1
    _native(monkeypatch)
    pp.reset_encoders_run()
    tok = Tokenizer()
    tok.fit_on_texts(np.array(["a", "b", "a"], dtype=object))
    np.testing.assert_array_equal(tok.encode_category(np.array(["a", "c"], dtype=object)),
                                  [1, 0])
    assert pp.encoders_run() == {"category": "python"}


def _kkbox_config(root, csv):
    """A config directory for a tiny KKBox-shaped experiment with string
    ids and a genre sequence, one epoch."""
    params = chip_smoke.native_dataset_params(csv, str(root / "data") + "/")
    params["dataset_id"] = "kk_tiny"
    model = {"Base": {"model_root": str(root / "exps") + "/", "metrics": ["AUC"],
                      "monitor": "AUC", "seed": 3, "shuffle": False, "epochs": 1,
                      "optimizer": "adam", "loss": "binary_crossentropy",
                      "retrieval_augmented": False},
             "RAT_m2_kk_tiny": {"dataset_id": "kk_tiny", "model": "RAT_m2",
                                "batch_size": 256, "embedding_dim": 8,
                                "dnn_hidden_units": [16], "num_heads": 2, "depth": 1,
                                "dim_head": 4, "scale_dim": 2, "learning_rate": 1e-3}}
    params["min_categr_count"] = 1
    config = root / "config"
    config.mkdir()
    (config / "model_config.yaml").write_text(json.dumps(model))
    (config / "dataset_config.yaml").write_text(json.dumps({"kk_tiny": params}))
    return str(config)


def test_cli_splits_the_build_and_names_the_encoder(tmp_path, monkeypatch):
    from rat_tpu_torch.cli.run_expid import run_experiment
    csv = str(tmp_path / "csv")
    make_kkbox_like(csv, n_train=600, n_valid=200, n_test=200, seed=1)
    config = _kkbox_config(tmp_path, csv)
    _native(monkeypatch)
    run_experiment(config, "RAT_m2_kk_tiny", gpu=-1)
    with open(str(tmp_path / "exps" / "kk_tiny" / "RAT_m2_kk_tiny.log")) as fh:
        lines = {key: json.loads(line.split(key, 1)[1]) for line in fh
                 for key in ("Stage seconds: ", "Host encoder: ") if key in line}
    assert lines["Host encoder: "] == {"category": "native", "count_tokens": "native",
                                       "sequence": "native"}
    stages = lines["Stage seconds: "]
    split = [stages["build_" + k] for k in ("csv_read", "fit", "transform", "npy_write")]
    assert all(s >= 0 for s in split) and sum(split) <= stages["build"]


def test_chip_smoke_native_phase_on_cpu(tmp_path):
    res = chip_smoke.native(0, str(tmp_path), rows=(2000, 300, 300),
                            vocab={"n_users": 150, "n_songs": 300, "n_genres": 25},
                            min_rows=0)
    assert res["python_h"] and res["feature_map_identical"] and res["splits_equal"]
    for name in ("native", "python"):
        assert set(res[name + "_build_s"]) == {"csv_read", "fit", "transform", "npy_write",
                                               "total"}
    assert pp._NATIVE_MIN_ROWS == 50_000
    shutil.rmtree(str(tmp_path))
