"""Inputs made from the seed: the splits of a configuration's dataset,
and the seeds of everything else a run draws.

``splits`` is a copy of chip_smoke.py's ``mltag_arrays``, read from a
configuration file instead of constants: each field's ids follow a Zipf
law over its vocabulary (an exponent that the configuration assumes), so
BM25 matches and ties are frequent, and labels come from latent per-id
propensities. Every
split of the dataset is drawn in one pass, so one seed gives the same
rows in every cell, whichever splits a cell uses.
"""

import numpy as np

SPLITS = ("train", "valid", "test")


def seeds(seed):
    """Independent 32-bit seeds for the data, the weights, the program
    (its batch order) and the sample that is checked, from any whole
    number."""
    data, weights, program, sample = np.random.SeedSequence(int(seed)).generate_state(4)
    return {"data": int(data), "weights": int(weights), "program": int(program),
            "sample": int(sample)}


def sizes(cfg, rehearse):
    """(field vocabularies, split rows, batch size) of the run: the
    configuration's, or the small ones of its ``rehearsal`` block."""
    ds = cfg["dataset"]
    if rehearse:
        r = cfg["rehearsal"]
        return r["fields"], r["rows"], r["batch_size"]
    return ds["fields"], ds["rows"], cfg["batch_size"]


def splits(cfg, seed, rehearse=False):
    """{split: rows [n, F + 1] float64}: F ids (1 .. vocab - 1) and a 0/1
    label per row."""
    ds = cfg["dataset"]
    vocab, rows, _ = sizes(cfg, rehearse)
    rng = np.random.RandomState(seed)
    n = sum(rows[s] for s in SPLITS)
    cols, logit = [], np.full(n, float(ds["label_base_logit"]))
    for size in vocab.values():
        p = 1.0 / np.arange(1, size) ** ds["zipf_a"]
        ids = 1 + rng.choice(size - 1, n, p=p / p.sum())
        cols.append(ids)
        logit += rng.normal(0, ds["label_id_scale"], size)[ids]
    label = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))
    table = np.stack(cols + [label], axis=1).astype(np.float64)
    out, lo = {}, 0
    for s in SPLITS:
        out[s] = table[lo:lo + rows[s]]
        lo += rows[s]
    return out
