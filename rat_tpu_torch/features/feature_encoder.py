"""FeatureEncoder (port of rat_tpu.features.feature_encoder, on the
``csv_table`` dicts instead of pandas frames).

``transform`` returns one [N, input_length + 1] float64 matrix whose
columns follow feature_specs order with the label last; fitting records
vocab sizes, padding indices, sharing and pretrained-embedding metadata
into the FeatureMap; the encoder pickles itself next to
feature_map.json, which is byte-identical to the JAX package's.

Fitting is a dispatch table — one ``_fit_<kind>`` handler per (type,
encoder) pair, each returning the spec entries it contributes.
Numeric-bucket boundaries are sklearn's ``QuantileTransformer``
quantiles computed with ``np.nanpercentile`` (sklearn subsamples above
10,000 rows with an unseeded RNG, so only smaller columns can agree).
"""

import logging
import os
import pickle
from collections import Counter

import numpy as np

from . import csv_table
from .feature_map import FeatureMap
from .preprocess import Normalizer, Tokenizer


def _expand_column_groups(feature_cols):
    """A spec whose ``name`` is a list is shorthand for several columns
    sharing one config — flatten to one spec per column."""
    flat = []
    for spec in feature_cols:
        names = spec["name"] if isinstance(spec["name"], list) else [spec["name"]]
        flat.extend(dict(spec, name=n) for n in names)
    return flat


def _to_float(values):
    """``pd.to_numeric(...)`` of a column as float64 (NaN stays NaN)."""
    values = np.asarray(values)
    if values.dtype != object:
        return values.astype(np.float64)
    return np.array([np.nan if v is None else float(v) for v in values.tolist()],
                    dtype=np.float64)


class FeatureEncoder(object):
    def __init__(self,
                 feature_cols=[],
                 label_col={},
                 dataset_id=None,
                 data_root="../data/",
                 version="torch",
                 **kwargs):
        logging.info("Set up feature encoder...")
        self.data_dir = os.path.join(data_root, dataset_id)
        self.pickle_file = os.path.join(self.data_dir, "feature_encoder.pkl")
        self.json_file = os.path.join(self.data_dir, "feature_map.json")
        self.feature_cols = _expand_column_groups(feature_cols)
        self.label_col = label_col
        self.version = version
        self.feature_map = FeatureMap(dataset_id, self.data_dir, version)
        self.encoders = dict()

    # ---------------- CSV ingest ----------------

    def read_csv(self, data_path):
        paths = [data_path] if isinstance(data_path, str) else list(data_path)
        logging.info("Reading file: " + ", ".join(paths))
        dtypes = {spec["name"]: spec["dtype"]
                  for spec in self.feature_cols + [self.label_col]}
        return csv_table.read_csv(paths, dtypes)

    def preprocess(self, ddf, fill_na=True):
        """Fill NAs and run per-column custom hooks; label first, then
        features in REVERSE spec order (hooks may read raw columns that
        earlier-spec'd hooks would otherwise have consumed)."""
        logging.info("Preprocess feature columns...")
        for spec in [self.label_col] + self.feature_cols[::-1]:
            name = spec["name"]
            if fill_na and name in ddf:
                ddf[name] = self._filled(spec, ddf[name])
            hook = spec.get("preprocess")
            if hook:
                ddf[name] = np.asarray(getattr(self, hook)(ddf, name))
        keep = [self.label_col["name"]] + [
            spec["name"] for spec in self.feature_cols if spec["active"]]
        return {name: ddf[name] for name in keep}

    def _filled(self, spec, values):
        missing = csv_table.is_missing(values)
        if not missing.any():
            return values
        if "na_value" in spec and spec["na_value"] is not None:
            fill = spec["na_value"]
        elif spec["dtype"] in ("str", str):
            fill = ""
        else:
            raise RuntimeError("Feature column={} requires to assign na_value!"
                               .format(spec["name"]))
        out = values.astype(object) if isinstance(fill, str) else values.copy()
        out[missing] = fill
        return out

    # ---------------- fitting ----------------

    def fit(self, ddf, min_categr_count=1, num_buckets=10, **kwargs):
        logging.info("Fit feature encoder...")
        self.feature_map.num_fields = 0
        for spec in self.feature_cols:
            if not spec["active"]:
                continue
            logging.info("Processing column: {}".format(spec))
            self.fit_feature_col(spec, ddf[spec["name"]],
                                 min_categr_count=min_categr_count,
                                 num_buckets=num_buckets)
            self.feature_map.num_fields += 1
        self.feature_map.set_feature_index()
        self.save_pickle(self.pickle_file)
        self.feature_map.save(self.json_file)
        logging.info("Set feature encoder done.")

    def fit_feature_col(self, feature_column, feature_values,
                        min_categr_count=1, num_buckets=10):
        """Fit one column and register its FeatureMap spec entries.

        Dispatch: numeric -> optional Normalizer; categorical -> ranked
        Tokenizer / quantile buckets / hash buckets by ``encoder``;
        sequence -> splitting Tokenizer with padding."""
        name = feature_column["name"]
        ftype = feature_column["type"]
        entry = {"source": feature_column.get("source", ""), "type": ftype}
        for passthrough in ("min_categr_count", "embedding_dim"):
            if passthrough in feature_column:
                entry[passthrough] = feature_column[passthrough]
        min_categr_count = feature_column.get("min_categr_count",
                                              min_categr_count)

        handlers = {
            ("numeric", ""): self._fit_numeric,
            ("categorical", ""): self._fit_categorical,
            ("categorical", "numeric_bucket"): self._fit_numeric_bucket,
            ("categorical", "hash_bucket"): self._fit_hash_bucket,
            ("sequence", None): self._fit_sequence,
        }
        encoder_name = feature_column.get("encoder", "")
        key = (ftype, None) if ftype == "sequence" else (ftype, encoder_name)
        if key not in handlers:
            raise NotImplementedError("feature_col={}".format(feature_column))
        if ftype == "categorical" and encoder_name:
            entry["encoder"] = encoder_name
        entry.update(handlers[key](
            feature_column, feature_values,
            min_categr_count=min_categr_count, num_buckets=num_buckets) or {})
        self.feature_map.feature_specs[name] = entry

    def _fit_numeric(self, spec, values, **kwargs):
        scaler = spec.get("normalizer")
        if scaler is not None:
            normalizer = Normalizer(scaler)
            normalizer.fit(_to_float(values))
            self.encoders[spec["name"] + "_normalizer"] = normalizer
        self.feature_map.num_features += 1
        return {}

    def _build_tokenizer(self, spec, values, min_categr_count, sequence):
        """Shared tokenizer construction for categorical and sequence
        columns: fit or alias a shared vocab, then optionally merge a
        pretrained embedding table."""
        name = spec["name"]
        entry = {}
        tok = Tokenizer(min_freq=min_categr_count,
                        na_value=spec.get("na_value", ""),
                        splitter=spec.get("splitter", " ") if sequence else None,
                        max_len=spec.get("max_len", 0) if sequence else 0,
                        padding=spec.get("padding", "post") if sequence else "pre")
        shared = spec.get("share_embedding")
        if shared is not None:
            entry["share_embedding"] = shared
            if sequence and spec.get("max_len") is None:
                tok.fit_on_texts(values, use_padding=True)  # only for max_len
            tok.set_vocab(self.encoders[shared + "_tokenizer"].vocab)
        else:
            pad = sequence or self._feeds_a_sequence_vocab(name)
            tok.fit_on_texts(values, use_padding=pad)
        if "pretrained_emb" in spec:
            logging.info("Loading pretrained embedding: " + name)
            entry["pretrained_emb"] = "pretrained_{}.h5".format(name)
            entry["freeze_emb"] = spec.get("freeze_emb", True)
            tok.load_pretrained_embedding(
                name, spec["pretrained_emb"], spec["embedding_dim"],
                os.path.join(self.data_dir, entry["pretrained_emb"]),
                feature_dtype=spec.get("dtype"),
                freeze_emb=entry["freeze_emb"])
        self.encoders[name + "_tokenizer"] = tok
        self.feature_map.num_features += tok.vocab_size
        entry["vocab_size"] = tok.vocab_size
        return tok, entry

    def _fit_categorical(self, spec, values, min_categr_count=1, **kwargs):
        tok, entry = self._build_tokenizer(spec, values, min_categr_count,
                                           sequence=False)
        if tok.use_padding:
            entry["padding_idx"] = tok.vocab_size - 1
        return entry

    def _fit_sequence(self, spec, values, min_categr_count=1, **kwargs):
        tok, entry = self._build_tokenizer(spec, values, min_categr_count,
                                           sequence=True)
        entry["encoder"] = spec.get("encoder", "MaskedAveragePooling")
        entry["padding_idx"] = tok.vocab_size - 1
        entry["max_len"] = tok.max_len
        return entry

    def _fit_numeric_bucket(self, spec, values, num_buckets=10, **kwargs):
        num_buckets = spec.get("num_buckets", num_buckets)
        references = np.linspace(0, 1, num_buckets + 1, endpoint=True) * 100
        quantiles = np.maximum.accumulate(np.nanpercentile(_to_float(values),
                                                           references))
        self.encoders[spec["name"] + "_boundaries"] = quantiles[1:-1]
        self.feature_map.num_features += num_buckets
        return {"vocab_size": num_buckets}

    def _fit_hash_bucket(self, spec, values, num_buckets=10, **kwargs):
        num_buckets = min(spec.get("num_buckets", num_buckets),
                          len(Counter(np.asarray(values).tolist())))
        self.encoders[spec["name"] + "_num_buckets"] = num_buckets
        self.feature_map.num_features += num_buckets
        return {"vocab_size": num_buckets}

    def _feeds_a_sequence_vocab(self, feature):
        """True when a sequence column aliases this column's vocab via
        share_embedding — the vocab then needs the PAD entry."""
        return any(spec.get("share_embedding") == feature
                   and spec["type"] == "sequence"
                   for spec in self.feature_cols)

    # ---------------- transform ----------------

    def transform(self, ddf):
        """Encode every fitted column and append the label: one
        preallocated [N, input_length + 1] float matrix, filled block
        by block in feature_specs order."""
        logging.info("Transform feature columns...")
        n = csv_table.num_rows(ddf)
        out = np.empty((n, self.feature_map.input_length + 1))
        pos = 0
        for feature, spec in self.feature_map.feature_specs.items():
            block = self._encode_column(feature, spec, ddf)
            width = 1 if block.ndim == 1 else block.shape[1]
            out[:, pos:pos + width] = block.reshape(n, width)
            pos += width
        out[:, -1] = _to_float(ddf[self.label_col["name"]])
        return out

    def _encode_column(self, feature, spec, ddf):
        ftype = spec["type"]
        if ftype == "numeric":
            col = _to_float(ddf[feature])
            col = np.where(np.isnan(col), 0.0, col)
            normalizer = self.encoders.get(feature + "_normalizer")
            return normalizer.normalize(col) if normalizer else col
        if ftype == "categorical":
            if spec.get("encoder", ""):
                raise NotImplementedError(
                    "encoder={}".format(spec["encoder"]))
            return self.encoders[feature + "_tokenizer"].encode_category(ddf[feature])
        if ftype == "sequence":
            return self.encoders[feature + "_tokenizer"].encode_sequence(ddf[feature])
        raise NotImplementedError("type={}".format(ftype))

    # ---------------- persistence ----------------

    def save_pickle(self, pickle_file):
        logging.info("Pickle feature_encoder: " + pickle_file)
        os.makedirs(os.path.dirname(pickle_file) or ".", exist_ok=True)
        with open(pickle_file, "wb") as fh:
            pickle.dump(self, fh)

    def load_pickle(self, pickle_file=None):
        pickle_file = pickle_file or self.pickle_file
        logging.info("Load feature_encoder from pickle: " + pickle_file)
        if os.path.exists(pickle_file):
            with open(pickle_file, "rb") as fh:
                cached = pickle.load(fh)
            if cached.feature_map.dataset_id == self.feature_map.dataset_id:
                cached.version = self.version
                return cached
        raise IOError("pickle_file={} not valid.".format(pickle_file))
