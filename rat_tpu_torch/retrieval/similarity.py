"""Alternative retrieval utilities (port of
rat_tpu.retrieval.similarity). No kernel lies behind either.

- jaccard_similarity: batched padding-aware Jaccard between ID-row
  matrices (reference: data_utils.py:59-93), in torch;
- map_indices: "index of each query value in keys" via argsort +
  searchsorted, missing -> -1 (data_utils.py:98-122), in numpy.
"""

import numpy as np
import torch


def jaccard_similarity(u, v, padding_idx=0):
    """u: [X, D], v: [Y, D'] int tensors (or arrays) -> [X, Y] float32
    Jaccard scores, with 1e-3 added to the union.

    NOTE (reference contract): rows of ``u`` must not contain repeated
    values; intersection counts each u-token found anywhere in the
    v-row.
    """
    u = torch.as_tensor(u)
    v = torch.as_tensor(v)
    u_valid = u != padding_idx
    v_valid = v != padding_idx
    # [X,1,D,1] == [1,Y,1,D'] -> [X,Y,D,D']
    sims = u[:, None, :, None] == v[None, :, None, :]
    count_intersection = (sims.any(dim=-1) & u_valid[:, None, :]).sum(dim=-1)
    count_union = (u_valid.sum(dim=-1, keepdim=True) + v_valid.sum(dim=-1)
                   - count_intersection)
    return count_intersection / (count_union + 1e-3)


def map_indices(keys, queries, missing=-1, is_key_sorted=False):
    """Index of each query value within keys; missing -> ``missing``."""
    keys = np.asarray(keys)
    queries = np.asarray(queries)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    if is_key_sorted:
        sorter = np.arange(len(keys))
    else:
        sorter = np.argsort(keys, kind="mergesort")
    insertion = np.searchsorted(keys, queries, sorter=sorter)
    insertion = np.clip(insertion, 0, len(keys) - 1)
    indices = sorter[insertion]
    invalid = keys[indices] != queries
    return np.where(invalid, missing, indices)
