"""Retrieval traffic: the BM25 pre-retrieval that comes before every
training run, a ``DataGenerator`` of the train split with its X-fold
self-retrieval (the IDF tables of each fold's pool on the host, the
scans on the device, the results back), pass after pass. No model runs.
Set-up makes ``warm_passes`` passes, so that the kernels are loaded and
the allocators hold a pass's buffers; the window ends at the first pass
boundary after ``--seconds``."""

import time

import torch

from .. import data, program
from ..reference import judge
from . import common


def setup(run):
    cfg = run.cfg
    vocab, _, run.batch = data.sizes(cfg, run.rehearse)
    run.splits = {"train": data.splits(cfg, run.seeds["data"], run.rehearse)["train"]}
    run.vocab = vocab
    run.rows = common.sample(len(run.splits["train"]), run.traffic["check_rows"],
                             run.seeds["sample"])
    run.fm = program.feature_map(cfg, vocab)
    for _ in range(run.traffic["warm_passes"]):
        program.generator(cfg, run.fm, run.batch, run.device, run.splits["train"])


def window(run, seconds):
    trace = run.traffic_trace
    train = run.splits["train"]
    k2_before = program.k2_launches()
    passes, ends = 0, []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if passes + 1 == trace["start_pass"]:
            run.tracer.start()
        with run.tracer.span("retrieval"):
            gen = program.generator(run.cfg, run.fm, run.batch, run.device, train)
        passes += 1
        ends.append(time.perf_counter())
        if passes == trace["start_pass"]:
            run.tracer.stop()
        if time.perf_counter() >= deadline and run.tracer.done:
            break
    program.sync(run.device)
    wall = time.perf_counter() - t0
    run.gen = gen
    run.e2e["retrieval_queries_per_s"] = passes * len(train) / wall
    run.counters.update(window_s=wall, passes=passes, queries=passes * len(train),
                        k2_launches=program.k2_launches() - k2_before,
                        pass_s=common.quartiles(ends, t0))
    run.attempted = passes * len(train)
    run.failed = 0


def check(run):
    """The neighbour gap of the last pass's answer for the checked rows;
    in a control run, of the reference's answer summed in the control's
    precision."""
    ref = common.retrieval(run.cfg, run.splits["train"], run.vocab, run.device)
    if run.control:
        return {"nbr_score_gap": common.control_neighbours(ref, run.rows)[0]}
    nb = run.gen.retr_indices[run.rows]
    scores = run.gen.retr_values[run.rows]
    gap = judge.neighbour_gap(ref.run(run.rows), ref.db,
                              torch.from_numpy(nb).to(run.device),
                              torch.from_numpy(scores).to(run.device))
    return {"nbr_score_gap": gap}
