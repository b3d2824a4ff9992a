"""The share of the profiled retrieval pass during which the card idled
while the host cut a fold's pool and queries, copied them to int64,
transposed and uploaded them, collected the answers or mapped them to
split rows (innermost program span ``retrieval.fold_pool``,
``bm25.prepare``, ``bm25.upload``, ``bm25.collect`` or
``retrieval.remap``)."""

from benchmarks import program_spans

SPANS = ("retrieval.fold_pool", "bm25.prepare", "bm25.upload", "bm25.collect",
         "retrieval.remap")


def read(run):
    return program_spans.idle_percent(run, SPANS)
