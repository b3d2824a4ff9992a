"""The share of the profiled retrieval pass during which the card idled
while the host computed a fold pool's IDF tables or packed and uploaded
them (innermost program span ``bm25.idf`` or ``bm25.idf_pack``)."""

from benchmarks import program_spans

SPANS = ("bm25.idf", "bm25.idf_pack")


def read(run):
    return program_spans.idle_percent(run, SPANS)
