"""The port's column encoders (rat_tpu_torch/features/preprocess.py and
csv_table.py) against the JAX package's pandas/sklearn ones on the same
inputs: Tokenizer vocabularies and encodings, Normalizer, the
numeric-bucket boundaries, pad_sequences, and CSV reading."""

import numpy as np
import pandas as pd
import pytest
import sklearn.preprocessing as sk

from rat_tpu.features import Normalizer as JNormalizer
from rat_tpu.features import Tokenizer as JTokenizer
from rat_tpu.features import pad_sequences as jpad_sequences
from rat_tpu_torch.features import FeatureEncoder, Normalizer, Tokenizer, pad_sequences
from rat_tpu_torch.features import csv_table


def _pair(**kw):
    return JTokenizer(**kw), Tokenizer(**kw)


def _same_vocab(jtok, tok):
    assert tok.vocab == jtok.vocab
    assert list(tok.vocab) == list(jtok.vocab)
    assert tok.vocab_size == jtok.vocab_size and tok.max_len == jtok.max_len


@pytest.mark.parametrize("kind", ["float_ids", "strings", "ints"])
@pytest.mark.parametrize("min_freq", [1, 3])
def test_categorical_vocab_and_encoding_match_jax(kind, min_freq):
    rng = np.random.RandomState(3)
    ids = rng.zipf(1.6, 5000) % 400
    values = {"float_ids": ids.astype(np.float64),
              "strings": np.array(["s%d" % i for i in ids], dtype=object),
              "ints": ids.astype(np.int64)}[kind]
    jtok, tok = _pair(min_freq=min_freq, na_value="")
    jtok.fit_on_texts(values)
    tok.fit_on_texts(values)
    _same_vocab(jtok, tok)
    if kind == "float_ids":
        assert all(isinstance(k, float) for k in tok.vocab if k not in ("__OOV__",))
    probe = np.concatenate([values[:700], values[:5] * 0 + values[-1]])
    if kind == "strings":
        probe = np.concatenate([probe, np.array(["unseen", "s1"], dtype=object)])
    else:
        probe = np.concatenate([probe, np.array([10_000, 1], dtype=values.dtype)])
    got = tok.encode_category(probe)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jtok.encode_category(probe))


def test_na_value_padding_num_words_and_lower_match_jax():
    values = np.array(["B", "a", "", "", "a", "C", "B", "B"], dtype=object)
    for kw in ({"na_value": ""}, {"na_value": "a"}, {"num_words": 2},
               {"lower": True}, {"oov_token": 1}):
        for pad in (False, True):
            jtok, tok = _pair(**kw)
            jtok.fit_on_texts(values, use_padding=pad)
            tok.fit_on_texts(values, use_padding=pad)
            _same_vocab(jtok, tok)
            np.testing.assert_array_equal(tok.encode_category(values),
                                          jtok.encode_category(values))


@pytest.mark.parametrize("padding", ["pre", "post"])
@pytest.mark.parametrize("max_len", [0, 2, 4])
def test_sequence_vocab_and_encoding_match_jax(padding, max_len):
    rng = np.random.RandomState(5)
    rows = ["|".join(str(g) for g in rng.choice(30, rng.randint(0, 6), replace=False))
            for _ in range(3000)]
    texts = np.array(rows + ["", "7", "99|7"], dtype=object)
    jtok, tok = _pair(splitter="|", max_len=max_len, padding=padding, min_freq=2,
                      na_value="")
    jtok.fit_on_texts(texts, use_padding=True)
    tok.fit_on_texts(texts, use_padding=True)
    _same_vocab(jtok, tok)
    got = tok.encode_sequence(texts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jtok.encode_sequence(texts))


def test_shared_vocab_matches_jax():
    base = np.array(["x", "y", "y", "z"], dtype=object)
    seqs = np.array(["x y", "q", "", "z z y"], dtype=object)
    out = []
    for Tok in (JTokenizer, Tokenizer):
        owner = Tok(na_value="")
        owner.fit_on_texts(base, use_padding=True)
        shared = Tok(splitter=" ", padding="post")
        shared.fit_on_texts(seqs, use_padding=True)   # for max_len only
        shared.set_vocab(owner.vocab)
        out.append((shared.vocab_size, shared.max_len, shared.encode_sequence(seqs)))
    assert out[0][:2] == out[1][:2]
    np.testing.assert_array_equal(out[0][2], out[1][2])


@pytest.mark.parametrize("scaler", ["StandardScaler", "MinMaxScaler"])
@pytest.mark.parametrize("column", ["normal", "constant", "wide"])
def test_normalizer_matches_sklearn_backed_jax(scaler, column):
    rng = np.random.RandomState(7)
    x = {"normal": rng.randn(4000) * 3 + 1.5, "constant": np.full(100, 2.25),
         "wide": rng.exponential(1e4, 2000)}[column]
    jn, n = JNormalizer(scaler), Normalizer(scaler)
    jn.fit(x)
    n.fit(x)
    probe = np.concatenate([x, [-5.0, 0.0, 1e5]])
    np.testing.assert_allclose(n.normalize(probe), jn.normalize(probe), rtol=0,
                               atol=1e-12)


def test_normalizer_callable_and_unknown():
    n = Normalizer(lambda v: v * 2)
    n.fit(np.array([1.0]))
    np.testing.assert_array_equal(n.normalize(np.array([1.0, 2.0])), [2.0, 4.0])
    with pytest.raises(NotImplementedError):
        Normalizer("Nope")


@pytest.mark.parametrize("rows", [50, 1001, 10_000])
@pytest.mark.parametrize("buckets", [4, 10])
def test_numeric_bucket_boundaries_match_sklearn(tmp_path, rows, buckets):
    """The JAX package fits sklearn's QuantileTransformer(n_quantiles =
    buckets + 1) and keeps quantiles_[1:-1]; sklearn subsamples above
    10,000 rows with an unseeded RNG, so parity holds up to there."""
    x = np.random.RandomState(rows).gamma(2.0, 3.0, rows).round(2)
    qtf = sk.QuantileTransformer(n_quantiles=buckets + 1).fit(x.reshape(-1, 1))
    enc = FeatureEncoder(feature_cols=[], label_col={}, dataset_id="b",
                         data_root=str(tmp_path))
    spec = {"name": "n", "type": "categorical", "encoder": "numeric_bucket",
            "num_buckets": buckets}
    enc._fit_numeric_bucket(spec, x)
    np.testing.assert_array_equal(enc.encoders["n_boundaries"], qtf.quantiles_[1:-1, 0])


def test_pad_sequences_matches_jax():
    rng = np.random.RandomState(1)
    seqs = [list(rng.randint(1, 50, rng.randint(0, 7))) for _ in range(200)]
    for kw in ({}, {"maxlen": 3}, {"maxlen": 5, "padding": "post"},
               {"maxlen": 2, "truncating": "post", "value": 9},
               {"maxlen": 4, "padding": "post", "truncating": "post"}):
        np.testing.assert_array_equal(pad_sequences(seqs, **kw),
                                      jpad_sequences(seqs, **kw))
    with pytest.raises(AssertionError):
        pad_sequences(seqs, padding="middle")


def test_read_csv_matches_pandas_with_missing_cells(tmp_path):
    """str/float/int columns and every pandas default NA string, in
    str columns too (a column without a dtype is read as str)."""
    na = sorted(csv_table.NA_VALUES)
    from pandas._libs.parsers import STR_NA_VALUES
    assert set(na) == set(STR_NA_VALUES)
    lines = ["s,f,i,x"]
    for k, token in enumerate(na):
        lines.append('{},{},{},{}'.format(token, token, k, k * 0.5))
    lines += ['"a,b",1.25,7,x1', "plain,-3e-2,8,2", "", "tail,nan,9,3"]
    path = tmp_path / "t.csv"
    path.write_text("\n".join(lines) + "\n")
    dtypes = {"s": str, "f": float, "i": "int"}
    got = csv_table.read_csv(str(path), dtypes)
    want = pd.read_csv(path, dtype=dict(dtypes, x=str))
    assert list(got) == list(want.columns)
    assert csv_table.num_rows(got) == len(want)
    for name in want.columns:
        missing = csv_table.is_missing(got[name])
        np.testing.assert_array_equal(missing, want[name].isnull().to_numpy(), err_msg=name)
        keep = ~missing
        np.testing.assert_array_equal(got[name][keep].astype(str),
                                      want[name][keep].to_numpy().astype(str), err_msg=name)
    with pytest.raises(ValueError):
        csv_table.read_csv(str(path), {"f": "int"})


def test_write_csv_round_trips_through_pandas(tmp_path):
    table = {"a": np.array([1.0, 0.1, 1e16, np.nan, -2.5e-7]),
             "b": np.array(["x", None, "y,z", 'q"r', ""], dtype=object),
             "c": np.arange(5, dtype=np.int64)}
    path = str(tmp_path / "w.csv")
    csv_table.write_csv(path, table)
    pd.DataFrame(table).to_csv(str(tmp_path / "p.csv"), index=False)
    assert open(path).read() == open(str(tmp_path / "p.csv")).read()
    back = csv_table.read_csv(path, {"a": float, "b": str, "c": int})
    np.testing.assert_array_equal(back["a"], table["a"])
    assert list(back["b"]) == ["x", None, "y,z", 'q"r', None]
    taken = csv_table.take(back, [4, 0])
    assert list(taken) == ["index", "a", "b", "c"]
    assert list(csv_table.take(taken, [1])) == ["level_0", "index", "a", "b", "c"]
    np.testing.assert_array_equal(taken["c"], [4, 0])
