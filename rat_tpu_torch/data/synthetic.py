"""Synthetic CTR datasets (port of rat_tpu.data.synthetic): the same RNG
calls in the same order as the JAX package's generators, so the same
rows come out, written by ``csv_table.write_csv`` as pandas' ``to_csv``
writes them.

The reference ships no data, so tests, smoke runs and benchmarks use
synthetic sets: ML-Tag-shaped (3 categorical fields and a label driven
by latent user/item/tag affinities), KKBox-shaped (categoricals plus a
'|'-separated sequence field) and Tmall-shaped at full scale.
"""

import os

import numpy as np

from ..features.csv_table import write_csv


def _write_splits(out_dir, table, n_train, n_valid):
    os.makedirs(out_dir, exist_ok=True)
    for name, lo, hi in (("train", 0, n_train), ("valid", n_train, n_train + n_valid),
                         ("test", n_train + n_valid, None)):
        write_csv(os.path.join(out_dir, name + ".csv"),
                  {k: v[lo:hi] for k, v in table.items()})


def make_mltag_like(out_dir, n_train=20000, n_valid=4000, n_test=4000,
                    n_users=500, n_items=300, n_tags=100, seed=0):
    rng = np.random.RandomState(seed)
    n = n_train + n_valid + n_test
    user = rng.randint(0, n_users, n)
    item = rng.randint(0, n_items, n)
    tag = rng.randint(0, n_tags, n)
    # latent affinity: label depends on stable user/item/tag propensities
    u_bias = rng.normal(0, 1.2, n_users)
    i_bias = rng.normal(0, 1.2, n_items)
    t_bias = rng.normal(0, 0.8, n_tags)
    u_vec = rng.normal(0, 1, (n_users, 4))
    i_vec = rng.normal(0, 1, (n_items, 4))
    logits = (u_bias[user] + i_bias[item] + t_bias[tag]
              + (u_vec[user] * i_vec[item]).sum(-1) * 0.7)
    prob = 1.0 / (1.0 + np.exp(-logits))
    label = (rng.uniform(size=n) < prob).astype(np.float64)
    table = {"user_id": user.astype(np.float64),
             "item_id": item.astype(np.float64),
             "tag_id": tag.astype(np.float64),
             "label": label}
    _write_splits(out_dir, table, n_train, n_valid)
    return table


def make_kkbox_like(out_dir, n_train=8000, n_valid=2000, n_test=2000,
                    n_users=300, n_songs=200, n_genres=30, seed=0):
    """KKBox-shaped synthetic set: categorical user/song plus a
    genre_ids SEQUENCE column ('|'-separated, 1-3 genres per song in
    random order per row)."""
    rng = np.random.RandomState(seed)
    n = n_train + n_valid + n_test
    user = rng.randint(0, n_users, n)
    song = rng.randint(0, n_songs, n)
    # each song has 1-3 stable genres; rows list them in random order
    song_genres = [rng.choice(n_genres, size=rng.randint(1, 4),
                              replace=False) for _ in range(n_songs)]
    genres = ["|".join(str(g) for g in
                       rng.permutation(song_genres[s]))
              for s in song]
    u_bias = rng.normal(0, 1.2, n_users)
    s_bias = rng.normal(0, 1.2, n_songs)
    g_bias = rng.normal(0, 0.8, n_genres)
    logits = (u_bias[user] + s_bias[song]
              + np.array([g_bias[song_genres[s]].mean() for s in song]))
    prob = 1.0 / (1.0 + np.exp(-logits))
    label = (rng.uniform(size=n) < prob).astype(np.float64)
    table = {"msno": user.astype(np.float64),
             "song_id": song.astype(np.float64),
             "genre_ids": np.array(genres, dtype=object),
             "label": label}
    _write_splits(out_dir, table, n_train, n_valid)
    return table


def make_tmall_like(out_dir, n_train=20_038_830, n_test=21_165_358,
                    n_pool=20_000_000, n_users=400_000, n_items=800_000,
                    n_cats=1600, n_sellers=200_000, n_brands=200_000,
                    seed=0, chunk_rows=2_000_000):
    """Full-Tmall-scale synthetic set (20M train / 21.2M test rows, an
    explicit retrieval-pool file, as configs/RAT_m2/tmall_x1_002 reads).
    Writes train.csv / test.csv / retrieval_pool.csv in streaming chunks
    so host memory stays at one chunk."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    # small latent tables drive the label so ids are informative
    u_bias = rng.normal(0, 0.9, 1024)
    i_bias = rng.normal(0, 0.9, 1024)
    c_bias = rng.normal(0, 0.6, 64)

    def write(path, n_rows):
        # stream into a sibling temp file and rename at the end: a
        # killed run must never leave a truncated CSV that a later run
        # (which keys on file existence) silently reuses
        tmp = path + ".tmp"
        first = True
        remaining = n_rows
        while remaining > 0:
            n = min(chunk_rows, remaining)
            remaining -= n
            user = rng.randint(0, n_users, n)
            item = rng.randint(0, n_items, n)
            cat = item % n_cats          # item determines category
            seller = item % n_sellers    # ... and seller/brand, Tmall-style
            brand = rng.randint(0, n_brands, n)
            action = rng.randint(0, 4, n)
            age = rng.randint(0, 9, n)
            gender = rng.randint(0, 3, n)
            logits = (u_bias[user % 1024] + i_bias[item % 1024]
                      + c_bias[cat % 64] + 0.4 * (action == 2) - 1.0)
            prob = 1.0 / (1.0 + np.exp(-logits))
            label = (rng.uniform(size=n) < prob).astype(np.int8)
            write_csv(tmp, {
                "time_stamp": np.zeros(n, np.int32), "user_id": user,
                "item_id": item, "cat_id": cat, "seller_id": seller,
                "brand_id": brand, "action_type": action,
                "age_range": age, "gender": gender, "label": label,
            }, mode="w" if first else "a", header=first)
            first = False
        os.replace(tmp, path)

    write(os.path.join(out_dir, "train.csv"), n_train)
    write(os.path.join(out_dir, "test.csv"), n_test)
    write(os.path.join(out_dir, "retrieval_pool.csv"), n_pool)
