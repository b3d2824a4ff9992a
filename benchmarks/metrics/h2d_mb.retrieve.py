"""Megabytes (10^6 bytes) copied to the card per retrieval pass in the
profiled stretch: the ``bytes`` of the program's ``bm25.upload`` (each
fold's pool and queries) and ``bm25.idf_pack`` (its IDF tables) spans,
over the passes that its ``retrieval.fold`` spans make up."""

from benchmarks import program_spans

SPANS = ("bm25.upload", "bm25.idf_pack")


def read(run):
    found = program_spans.spans(run)
    folds = sum(s.name == "retrieval.fold" for s in found)
    if not folds:
        return None
    per_pass = int(run.cfg["dataset"]["retrieval"]["split_type"].split("-")[0])
    nbytes = sum(s.counts.get("bytes", 0) for s in found if s.name in SPANS)
    return nbytes / 1e6 * per_pass / folds
