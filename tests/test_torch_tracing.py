"""rat_tpu_torch.tracing: off by default (the sites get the shared null
context and nothing is recorded), on between enable() and disable() and
while a torch.profiler session runs, parents and self time, the bound on
the spans kept, the clock shared with the profiler's events, and the
spans and counters that a fold self-retrieval, a grouped fit, an
evaluation and the ``profile_dir`` export record."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rat_tpu_torch import tracing
from rat_tpu_torch.data.loader import DataGenerator, _fold_self_retrieval
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.features import FeatureMap

RETRIEVAL = ("retrieval.fold", "retrieval.fold_pool", "bm25.prepare", "bm25.idf",
             "bm25.idf_pack", "bm25.upload", "bm25.scan", "bm25.collect",
             "retrieval.remap")
RC = {"used_col_indices": [0, 1, 2], "exact_match_col_indices": None,
      "split_type": "3-fold", "label_wise": False, "pre_retrieval": True,
      "qry_batch_size": 16, "db_chunk_size": None, "topK": 4}


@pytest.fixture(autouse=True)
def clean():
    """Each test starts and ends with recording off and nothing kept."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _names(spans):
    return [s.name for s in spans]


def test_off_records_nothing():
    assert not tracing.recording()
    before = tracing.counters()
    site = tracing.span("a", bytes=3)
    assert site is tracing.span("b") is tracing._NULL
    with site as s:
        s.add(bytes=1)
        tracing.count("c")
    assert tracing.take() == []
    assert tracing.counters() == before and "c" not in before


def test_enable_take_parents_and_self_time():
    tracing.enable()
    with tracing.span("outer", calls=1) as outer:
        time.sleep(0.002)
        with tracing.span("inner", bytes=5) as inner:
            inner.add(bytes=2)
            time.sleep(0.002)
        with tracing.span("inner"):
            pass
        outer.add(calls=2)
    tracing.count("things", 3)
    tracing.count("things")
    tracing.disable()
    with tracing.span("after"):
        pass
    spans = tracing.take()
    assert _names(spans) == ["outer", "inner", "inner"]
    assert [s.parent for s in spans] == [None, 0, 0]
    assert spans[0].counts == {"calls": 3} and spans[1].counts == {"bytes": 7}
    assert spans[2].counts == {}
    for s in spans:
        assert s.start_ns <= s.end_ns
    for child in spans[1:]:
        assert spans[0].start_ns <= child.start_ns and child.end_ns <= spans[0].end_ns
    dur = [s.end_ns - s.start_ns for s in spans]
    self_ns = dur[0] - dur[1] - dur[2]
    assert 0 < self_ns < dur[0] and self_ns >= 2e6
    assert tracing.counters()["things"] >= 4
    assert tracing.take() == []


def test_profiler_session_turns_recording_on_and_off():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert tracing.recording()
        with tracing.span("profiled"):
            pass
    finally:
        prof.stop()
    assert not tracing.recording()
    with tracing.span("not profiled"):
        pass
    assert _names(tracing.take()) == ["profiled"]


def test_bound_drops_the_oldest_and_counts_them():
    rec = tracing.Recorder(max_spans=3)
    rec.enable()
    for i in range(5):
        with rec.span("s{}".format(i)):
            pass
    assert rec.dropped() == 2
    assert _names(rec.take()) == ["s2", "s3", "s4"]
    assert rec.dropped() == 0
    # a parent dropped for the bound reads as no parent
    with rec.span("p"):
        for i in range(3):
            with rec.span("c{}".format(i)):
                pass
    spans = rec.take()
    assert _names(spans) == ["c0", "c1", "c2"] and [s.parent for s in spans] == [None] * 3


def test_open_spans_stay_for_a_later_take():
    tracing.enable()
    with tracing.span("long"):
        with tracing.span("short"):
            pass
        first = tracing.take()
    assert _names(first) == ["short"] and first[0].parent is None
    assert _names(tracing.take()) == ["long"]


def test_span_encloses_the_profilers_event():
    a = torch.randn(256, 256)
    a @ a
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with tracing.span("mm"):
        a @ a
    prof.stop()
    (span,) = tracing.take()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span.start_ns <= mm[0].start_ns() <= mm[0].end_ns() <= span.end_ns


def test_fold_self_retrieval_records_each_fold():
    rng = np.random.RandomState(3)
    data = np.concatenate([rng.randint(1, 9, (90, 3)), rng.randint(0, 2, (90, 1))], axis=1)
    tracing.enable()
    _fold_self_retrieval(data, dict(RC), device="cpu")
    tracing.disable()
    spans = tracing.take()
    names = _names(spans)
    for name in RETRIEVAL:
        assert names.count(name) == 3, name
    folds = [i for i, s in enumerate(spans) if s.name == "retrieval.fold"]
    assert all(spans[spans[i].parent].name == "retrieval.fold" for i in range(len(spans))
               if spans[i].name in ("retrieval.fold_pool", "retrieval.remap"))
    by = {n: [s for s in spans if s.name == n] for n in RETRIEVAL}
    # each fold: 30 queries against 60 pool rows, 3 fields, in batches of 16
    assert [s.counts["bytes"] for s in by["bm25.upload"]] == [4 * 3 * (60 + 30)] * 3
    assert [s.counts["calls"] for s in by["bm25.scan"]] == [2] * 3
    assert all(s.counts["bytes"] > 0 for s in by["bm25.idf_pack"])
    # values f32 and indices i32 of 4 slots, lens i64, for 30 queries
    assert [s.counts["bytes"] for s in by["bm25.collect"]] == [30 * (4 * 4 + 4 * 4 + 8)] * 3
    assert len(folds) == 3


def _feature_map():
    fm = FeatureMap("tiny", ".")
    for i, (name, size) in enumerate((("user_id", 20), ("item_id", 15), ("tag_id", 10))):
        fm.feature_specs[name] = {"source": "", "type": "categorical",
                                  "vocab_size": size, "index": i}
    fm.num_fields, fm.num_features, fm.input_length = 3, 45, 3
    return fm


def _gens(n_train=200, n_valid=64):
    rng = np.random.RandomState(5)

    def rows(n):
        ids = np.stack([rng.randint(1, v, n) for v in (20, 15, 10)], axis=1)
        return np.concatenate([ids, rng.randint(0, 2, (n, 1))], axis=1).astype(np.float64)

    train, valid = rows(n_train), rows(n_valid)
    rc = dict(RC, topK=2)
    return (DataGenerator(data_array=train, batch_size=16, shuffle=True,
                          retrieval_configs=rc, retrieval_pool_fname="self",
                          retrieval_augmented=True, device="cpu"),
            DataGenerator(data_array=valid, pool_array=train, batch_size=16,
                          retrieval_configs=rc, retrieval_pool_fname="train",
                          retrieval_augmented=True, device="cpu"))


def _trainer(demo_params, tmp_path, **over):
    params = dict(demo_params, model_root=str(tmp_path / "exps"), train_scan_batches=4,
                  **over)
    return Trainer(_feature_map(), params, device="cpu")


def test_grouped_fit_and_evaluate_record_dispatch_and_evaluation(demo_params, tmp_path):
    train, valid = _gens()
    trainer = _trainer(demo_params, tmp_path)
    before = tracing.counters().get("train.eager_steps", 0)
    tracing.enable()
    trainer.fit(train, valid, epochs=1)
    trainer.evaluate(valid)
    tracing.disable()
    spans = tracing.take()
    names = _names(spans)
    steps = len(train)   # 13 batches: 3 groups of 4, one per-step batch
    assert names.count("train.epoch") == 1
    assert names.count("train.step") == steps
    assert names.count("train.group") == 4
    assert names.count("train.device_split") == 3
    assert names.count("eval") == 2 and names.count("eval.metrics") == 2
    assert names.count("eval.dispatch") == 2 and names.count("eval.drain") == 2
    assert names.count("train.checkpoint") == 1
    assert tracing.counters()["train.eager_steps"] - before == steps
    parent = {s.name: set() for s in spans}
    for s in spans:
        parent[s.name].add(None if s.parent is None else spans[s.parent].name)
    assert parent["train.epoch"] == {None}
    assert parent["train.group"] == parent["train.checkpoint"] == {"train.epoch"}
    assert parent["train.step"] == {"train.group"}
    assert parent["eval"] == {"train.epoch", None}
    assert parent["eval.dispatch"] == parent["eval.drain"] == parent["eval.metrics"] == {"eval"}
    # fit uploads the valid split (64 rows, the train split its pool) and
    # the train split (200 rows, its own pool: another array); the last
    # evaluation uploads the valid split again
    split = [s for s in spans if s.name == "train.device_split"]
    assert [spans[s.parent].name if s.parent is not None else None
            for s in split] == [None, None, "eval"]
    tokens, labels, nbr = 3 * 8, 4, 2 * 8
    valid_bytes = 64 * (tokens + labels + nbr) + 200 * (tokens + labels)
    assert [s.counts["bytes"] for s in split] == [
        valid_bytes, 200 * (tokens + labels) * 2 + 200 * nbr, valid_bytes]


def test_profile_dir_writes_the_spans_beside_the_trace(demo_params, tmp_path):
    train, valid = _gens()
    out = tmp_path / "trace"
    trainer = _trainer(demo_params, tmp_path, profile_dir=str(out), profile_steps=3)
    trainer.fit(train, valid, epochs=1)
    assert not tracing.recording()
    (trace,) = glob.glob(str(out / "trace_*.json"))
    (spans,) = glob.glob(str(out / "spans_*.json"))
    assert os.path.basename(spans)[len("spans_"):] == os.path.basename(trace)[len("trace_"):]
    with open(trace) as fh:
        prof = json.load(fh)
    with open(spans) as fh:
        ours = json.load(fh)
    assert ours["baseTimeNanoseconds"] == prof.get("baseTimeNanoseconds", 0)
    (whole,) = [e for e in prof["traceEvents"] if e.get("name", "").startswith("PyTorch Profiler")]
    events = ours["traceEvents"]
    # steps 2 to 5 of the first epoch, one step per dispatch
    assert [e["name"] for e in events].count("train.step") == 4
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert whole["ts"] <= e["ts"] and e["ts"] + e["dur"] <= whole["ts"] + whole["dur"]
    assert tracing.take() == []
