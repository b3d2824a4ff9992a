"""Inputs made from the seed for a configuration with sequence fields
(``dataset.sequences``): the splits of KKBox-shaped rows.

A row holds one id column per categorical field and ``max_len`` id
columns per sequence field, in the configuration's field order, then a
0/1 label: the layout of the port's feature map, whose sequence fields
take ``max_len`` columns each.

- A categorical field's id follows a Zipf law over 1 .. vocab - 1, as in
  ``data.py`` (id 0 is left for the out-of-vocabulary slot).
- A sequence field holds 1 to ``max_len`` ids (the length uniform), each
  drawn by the same Zipf law over 1 .. vocab - 2, and is padded with
  vocab - 1, the id the port's embedding masks out. Ids within one
  sequence may repeat.
- Labels come from latent per-id propensities: the base logit plus, for
  every id of the row but the padding, one N(0, ``label_id_scale``)
  effect per id value.

Every split is drawn in one pass, so one seed gives the same rows
whatever splits a cell uses.
"""

import numpy as np

from . import data


def columns(cfg, vocab):
    """[(field, first column, width, is a sequence)] in field order."""
    seqs = cfg["dataset"]["sequences"]
    out, col = [], 0
    for name in vocab:
        width = seqs[name]["max_len"] if name in seqs else 1
        out.append((name, col, width, name in seqs))
        col += width
    return out


def splits(cfg, seed, rehearse=False):
    """{split: rows [n, C + 1] float64}: the C id columns and the label."""
    ds = cfg["dataset"]
    vocab, rows, _ = data.sizes(cfg, rehearse)
    rng = np.random.RandomState(seed)
    n = sum(rows[s] for s in data.SPLITS)
    cols, logit = [], np.full(n, float(ds["label_base_logit"]))
    for name, _, width, seq in columns(cfg, vocab):
        size = vocab[name]
        real = size - 1 if seq else size          # ids 1 .. real - 1
        p = 1.0 / np.arange(1, real) ** ds["zipf_a"]
        ids = 1 + rng.choice(real - 1, (n, width), p=p / p.sum())
        effect = rng.normal(0, ds["label_id_scale"], size)
        if seq:
            ids[np.arange(width)[None, :] >= rng.randint(1, width + 1, (n, 1))] = size - 1
            effect[size - 1] = 0.0
        cols.append(ids)
        logit += effect[ids].sum(axis=1)
    label = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))
    table = np.concatenate(cols + [label[:, None]], axis=1).astype(np.float64)
    out, lo = {}, 0
    for s in data.SPLITS:
        out[s] = table[lo:lo + rows[s]]
        lo += rows[s]
    return out
