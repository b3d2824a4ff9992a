"""Host-side column encoders: Tokenizer, Normalizer, pad_sequences (port
of rat_tpu.features.preprocess, on numpy and the standard library).

The vocabulary rules are the JAX package's:

- tokens rank by (-count, token); ids start at ``1 + oov_token``;
- OOV maps to index 0 (``oov_token``); ``__PAD__`` takes the LAST index
  when padding is enabled;
- ``vocab_size`` counts OOV (and PAD when present);
- sequence encode pads/truncates to ``max_len`` with the padding index.

Tokens keep the type of their column: a ``dtype: float`` id column
gives float keys (``5.0``, not ``"5"``). Category encoding maps each
distinct value once (``np.unique``) instead of every row. As in the JAX
package, columns of ``_NATIVE_MIN_ROWS`` rows or more go through the
native C++ encoder (rat_tpu_torch/native): its ``encode_category`` for
string vocabularies only, its ``encode_sequences`` and ``count_tokens``
for every sequence column, with the Python paths' outputs. Without it,
tokens are counted in one pass: the JAX package's spawned counting pool
is left out, since each worker imports torch before it counts and every
script that builds a dataset would need a ``__main__`` guard (PERF.md).
``encoders_run()``
says which encoder ran for each kind of column since the last
``reset_encoders_run()``. The scalers are numpy copies of sklearn's
``StandardScaler`` and ``MinMaxScaler``.
"""

import os
from collections import Counter
from itertools import chain

import numpy as np

from .. import native
from .csv_table import is_missing

# only worth building/binding the native encoder above this row count
_NATIVE_MIN_ROWS = 50_000

_encoders_run = {}


def reset_encoders_run():
    _encoders_run.clear()


def encoders_run():
    """{kind of column work: "native", "python" or "native+python"} since
    the last reset; kinds: category, sequence, count_tokens."""
    return {kind: "+".join(sorted(ran)) for kind, ran in sorted(_encoders_run.items())}


def _ran(kind, encoder):
    _encoders_run.setdefault(kind, set()).add(encoder)


def _fastenc(n_rows):
    """The native extension for a column of ``n_rows`` rows, or None."""
    if n_rows < _NATIVE_MIN_ROWS or not native.build():
        return None
    return native.fastenc


def count_tokens(texts, splitter):
    """(token -> count, longest row) over one chunk of sequence cells."""
    parts = [str(t).split(splitter) for t in texts]
    longest = max(map(len, parts), default=0)
    return Counter(chain.from_iterable(parts)), longest


def _clean_text_cells(texts):
    """Nulls -> '' so .split never sees NaN."""
    texts = np.asarray(texts, dtype=object)
    return np.where(is_missing(texts), "", texts).tolist()


def _value_counts(values):
    """{value: count} over a 1-D column, values as Python scalars."""
    values = np.asarray(values)
    if values.dtype == object:
        return Counter(values.tolist())
    keys, counts = np.unique(values, return_counts=True)
    return dict(zip(keys.tolist(), counts.tolist()))


def _map_through(values, vocab, missing):
    """Each value's vocab id (``missing`` when absent), as int64, with
    one dict lookup per distinct value."""
    values = np.asarray(values)
    if len(values) == 0:
        return np.zeros(0, dtype=np.int64)
    if values.dtype == object:
        uniq, inverse = {}, np.empty(len(values), dtype=np.int64)
        for j, v in enumerate(values.tolist()):
            inverse[j] = uniq.setdefault(v, len(uniq))
        ids = np.fromiter((vocab.get(v, missing) for v in uniq), dtype=np.int64,
                          count=len(uniq))
        return ids[inverse]
    uniq, inverse = np.unique(values, return_inverse=True)
    ids = np.fromiter((vocab.get(v, missing) for v in uniq.tolist()), dtype=np.int64,
                      count=len(uniq))
    return ids[inverse.reshape(-1)]


class Tokenizer(object):
    """Categorical/sequence values -> integer ids with a ranked vocab."""

    def __init__(self, num_words=None, na_value=None, min_freq=1, splitter=None,
                 lower=False, oov_token=0, max_len=0, padding="pre"):
        self._num_words = num_words
        self._na_value = na_value
        self._min_freq = min_freq
        self._lower = lower
        self._splitter = splitter
        self.oov_token = oov_token  # 0 reserved for __OOV__
        self.vocab = dict()
        self.vocab_size = 0  # includes oov and padding entries
        self.max_len = max_len
        self.padding = padding
        self.use_padding = False

    # ---------------- fitting ----------------

    def _count_sequence_tokens(self, texts):
        """Token counts and the longest row of a sequence column, through
        the native counter when the column is long enough, else one pass."""
        enc = _fastenc(len(texts))
        if enc is not None:
            _ran("count_tokens", "native")
            counts, longest = enc.count_tokens(_clean_text_cells(texts), self._splitter)
            return Counter(counts), longest
        _ran("count_tokens", "python")
        return count_tokens(list(texts), self._splitter)

    def fit_on_texts(self, texts, use_padding=False):
        self.use_padding = use_padding
        if self._splitter is None:  # scalar categorical column
            counts = _value_counts(texts)
        else:
            counts, longest = self._count_sequence_tokens(texts)
            if self.max_len == 0:
                self.max_len = longest
        self.build_vocab(counts)

    def build_vocab(self, word_counts):
        """Rank tokens by (count desc, token asc), drop rare/na tokens,
        and assign ids from ``1 + oov_token`` in rank order."""
        if not isinstance(word_counts, dict):
            word_counts = dict(word_counts)
        ranked = sorted(
            (t for t, c in word_counts.items()
             if c >= self._min_freq and t != self._na_value),
            key=lambda t: (-word_counts[t], t))
        if self._num_words:
            ranked = ranked[:self._num_words]
        if self._lower:
            ranked = [t.lower() for t in ranked]
        first_id = self.oov_token + 1
        self.vocab = {"__OOV__": self.oov_token}
        self.vocab.update(zip(ranked, range(first_id, first_id + len(ranked))))
        if self.use_padding:
            self.vocab["__PAD__"] = first_id + len(ranked)  # last index
        self.vocab_size = len(self.vocab) + self.oov_token

    # ---------------- encoding ----------------

    def _string_vocab(self):
        """True iff the REAL tokens are strings: the '__OOV__'/'__PAD__'
        sentinels are always str, so they must not decide (a float
        column's keys through str() would turn every value OOV)."""
        for k in self.vocab:
            if k not in ("__OOV__", "__PAD__"):
                return isinstance(k, str)
        return False

    def encode_category(self, categories):
        # the C++ map only pays for string keys, as in the JAX package
        enc = _fastenc(len(categories)) if self._string_vocab() else None
        if enc is not None:
            _ran("category", "native")
            return np.array(enc.encode_category(list(categories), self.vocab,
                                                self.oov_token), dtype=np.int64)
        _ran("category", "python")
        return _map_through(categories, self.vocab, self.oov_token)

    def encode_sequence(self, texts):
        pad_id = self.vocab_size - 1
        enc = _fastenc(len(texts))
        if enc is not None:
            _ran("sequence", "native")
            rows = enc.encode_sequences(
                _clean_text_cells(texts), self.vocab, self.oov_token, self._splitter,
                self.max_len, pad_id, self.padding == "pre", self.padding == "pre")
            return np.array(rows, dtype=np.int32).reshape(len(texts), self.max_len)
        _ran("sequence", "python")
        tokens = [t.split(self._splitter) if t else []
                  for t in _clean_text_cells(texts)]
        lens = np.fromiter(map(len, tokens), count=len(tokens), dtype=np.int64)
        flat = np.array(list(chain.from_iterable(tokens)), dtype=object)
        ids = _map_through(flat, self.vocab, self.oov_token)
        return _scatter_ragged(ids, lens, self.max_len, pad_id,
                               pad_pre=self.padding == "pre",
                               trunc_pre=self.padding == "pre")

    # ---------------- vocab IO ----------------

    def load_pretrained_embedding(self, feature_name, pretrain_path, embedding_dim,
                                  output_path, feature_dtype=str, freeze_emb=True):
        """Grow the vocab with pretrained keys and export the id-aligned
        embedding matrix to h5. PAD (when present) stays the last index
        with a zero vector; un-pretrained rows are zero when frozen,
        N(0, 1e-4) from the global numpy RNG otherwise."""
        import h5py
        if isinstance(feature_dtype, str):
            feature_dtype = {"str": str, "float": float, "int": int}[feature_dtype]
        with h5py.File(pretrain_path, "r") as hf:
            pre_keys = hf["key"][:].astype(feature_dtype)
            pre_vectors = hf["value"][:]
        novel = [k for k in pre_keys if k not in self.vocab]
        # new ids slot in where PAD sits (PAD then moves back to last)
        next_id = self.vocab.get("__PAD__", self.vocab_size)
        self.vocab.update(zip(novel, range(next_id, next_id + len(novel))))
        self.vocab_size += len(novel)
        if freeze_emb:
            matrix = np.zeros((self.vocab_size, embedding_dim))
        else:
            matrix = np.random.normal(0, 1e-4, (self.vocab_size, embedding_dim))
        if "__PAD__" in self.vocab:
            self.vocab["__PAD__"] = self.vocab_size - 1
            matrix[-1] = 0
        rows = np.fromiter((self.vocab[k] for k in pre_keys),
                           count=len(pre_keys), dtype=np.int64)
        matrix[rows] = pre_vectors
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        with h5py.File(output_path, "w") as hf:
            hf.create_dataset(feature_name, data=matrix)

    def set_vocab(self, vocab):
        self.vocab = vocab
        self.vocab_size = len(self.vocab) + self.oov_token


class _StandardScaler:
    """sklearn's StandardScaler on one column: the population std, a
    constant column scaled by 1 (sklearn's ``_is_constant_feature``)."""

    def fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        n = len(X)
        self.mean_ = np.sum(X) / n
        diff = X - self.mean_
        self.var_ = (np.sum(diff * diff) - np.sum(diff) ** 2 / n) / n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = 1.0 if constant else np.sqrt(self.var_)
        return self

    def transform(self, X):
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_


class _MinMaxScaler:
    """sklearn's MinMaxScaler on one column: ``X * scale + min`` with
    ``scale = 1 / range``, a range below 10 eps scaled by 1."""

    def fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        data_min, data_max = np.nanmin(X), np.nanmax(X)
        data_range = data_max - data_min
        if data_range < 10 * np.finfo(np.float64).eps:
            data_range = 1.0
        self.scale_ = 1.0 / data_range
        self.min_ = 0.0 - data_min * self.scale_
        return self

    def transform(self, X):
        return np.asarray(X, dtype=np.float64) * self.scale_ + self.min_


class Normalizer(object):
    """Numeric column scaler: a named scaler or any callable."""

    _SCALERS = {"StandardScaler": _StandardScaler, "MinMaxScaler": _MinMaxScaler}

    def __init__(self, normalizer):
        self.callable = callable(normalizer)
        if self.callable:
            self.normalizer = normalizer
        elif normalizer in self._SCALERS:
            self.normalizer = self._SCALERS[normalizer]()
        else:
            raise NotImplementedError("normalizer={}".format(normalizer))

    def fit(self, X):
        if not self.callable:
            self.normalizer.fit(np.asarray(X).reshape(-1))

    def normalize(self, X):
        if self.callable:
            return self.normalizer(X)
        return self.normalizer.transform(np.asarray(X).reshape(-1))


def _scatter_ragged(flat_values, lens, maxlen, fill, pad_pre, trunc_pre,
                    dtype=np.int32):
    """Scatter a concatenated ragged stream into a dense [N, maxlen]
    matrix in one shot.

    ``flat_values`` holds all rows' values back to back; ``lens[i]`` is
    row i's length. Truncation keeps the last (pre) or first (post)
    ``maxlen`` values; padding fills the front (pre) or back (post)."""
    n = len(lens)
    out = np.full((n, maxlen), fill, dtype=dtype)
    keep = np.minimum(lens, maxlen)
    total = int(keep.sum())
    if total == 0:
        return out
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    rows = np.repeat(np.arange(n), keep)
    # position within each row's kept window, 0..keep[i]-1
    kept_starts = np.concatenate([[0], np.cumsum(keep)[:-1]])
    within = np.arange(total) - np.repeat(kept_starts, keep)
    src_base = starts + (lens - keep if trunc_pre else 0)
    src = np.repeat(src_base, keep) + within
    dst = within + (np.repeat(maxlen - keep, keep) if pad_pre else 0)
    out[rows, dst] = flat_values[src]
    return out


def pad_sequences(sequences, maxlen=None, dtype="int32",
                  padding="pre", truncating="pre", value=0.):
    """Pad a list of lists to a dense [N, maxlen] array (keras semantics,
    as one flat scatter)."""
    for arg, name in ((padding, "padding"), (truncating, "truncating")):
        if arg not in ("pre", "post"):
            raise AssertionError("Invalid {}={}.".format(name, arg))
    lens = np.fromiter(map(len, sequences), count=len(sequences),
                       dtype=np.int64)
    if maxlen is None:
        maxlen = int(lens.max()) if len(lens) else 0
    flat = np.fromiter(chain.from_iterable(sequences),
                       count=int(lens.sum()), dtype=dtype)
    return _scatter_ragged(flat, lens, maxlen, value,
                           pad_pre=padding == "pre",
                           trunc_pre=truncating == "pre", dtype=dtype)
