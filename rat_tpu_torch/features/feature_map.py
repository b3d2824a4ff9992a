"""Dataset schema container (copy of rat_tpu.features.feature_map).

A ``FeatureMap`` records, in column order, everything the rest of the
stack needs to know about the encoded dataset: per-feature type,
vocabulary size, assigned column slot(s), padding row, embedding
overrides (dim / share / pretrained), plus the field, feature and
flattened-input counts. The on-disk form is a single JSON document so
a build is resumable without re-fitting the encoder.

Behavioral contract (reference: fuxictr/features.py:36-90):
  * column slots are assigned in spec order — one slot per scalar
    field, ``max_len`` consecutive slots per sequence field — and
    ``input_length`` is the total slot count;
  * the JSON document carries ``dataset_id`` / ``num_fields`` /
    ``num_features`` / ``input_length`` / ``feature_specs`` and loading
    a map built for a different ``dataset_id`` is an error.
"""

import json
import logging
import os
from collections import OrderedDict

logger = logging.getLogger(__name__)


class FeatureMap:
    def __init__(self, dataset_id, data_dir, version="tpu"):
        self.dataset_id = dataset_id
        # the embedding stack resolves pretrained tables relative to this
        self.data_dir = data_dir
        self.version = version
        self.num_fields = 0
        self.num_features = 0
        self.input_length = 0
        self.feature_specs = OrderedDict()

    def __repr__(self):
        return "FeatureMap({!r}, fields={}, features={}, input_length={})".format(
            self.dataset_id, self.num_fields, self.num_features, self.input_length)

    def set_feature_index(self):
        """Walk the specs in order and hand out column slots.

        Scalar fields consume one slot (stored as an int); sequence
        fields consume ``max_len`` slots (stored as a list, even when
        ``max_len`` is 1, so downstream code can tell the kinds apart).
        """
        logger.info("Assigning feature column slots")
        cursor = 0
        for spec in self.feature_specs.values():
            if spec["type"] == "sequence":
                width = spec["max_len"]
                spec["index"] = list(range(cursor, cursor + width))
            else:
                width = 1
                spec["index"] = cursor
            cursor += width
        self.input_length = cursor

    def get_feature_index(self, feature_type=None):
        """Slots of every feature whose type is in ``feature_type``.

        ``feature_type`` may be one type name or a list of them; with
        no argument the answer is empty (reference semantics).
        """
        if feature_type is None:
            return []
        wanted = feature_type if isinstance(feature_type, list) else [feature_type]
        return [spec["index"] for spec in self.feature_specs.values()
                if spec["type"] in wanted]

    # --- (de)serialization -------------------------------------------------

    def to_dict(self):
        doc = OrderedDict()
        doc["dataset_id"] = self.dataset_id
        doc["num_fields"] = self.num_fields
        doc["num_features"] = self.num_features
        doc["input_length"] = self.input_length
        doc["feature_specs"] = self.feature_specs
        return doc

    def from_dict(self, doc):
        if doc["dataset_id"] != self.dataset_id:
            raise RuntimeError(
                "feature map belongs to dataset_id={!r}, expected {!r}".format(
                    doc["dataset_id"], self.dataset_id))
        self.num_fields = doc["num_fields"]
        self.num_features = doc.get("num_features")
        self.input_length = doc.get("input_length")
        self.feature_specs = OrderedDict(doc["feature_specs"])

    def save(self, json_file):
        logger.info("Writing feature map: %s", json_file)
        parent = os.path.dirname(json_file)
        if parent and not os.path.isdir(parent):
            os.makedirs(parent)
        with open(json_file, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=4)

    def load(self, json_file):
        logger.info("Reading feature map: %s", json_file)
        with open(json_file, "r", encoding="utf-8") as fh:
            self.from_dict(json.load(fh, object_pairs_hook=OrderedDict))
