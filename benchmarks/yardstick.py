"""The yardstick: the card's published peaks and the operations and bytes
that the per-layer metrics divide by, computed from a configuration's
shapes alone. Nothing here reads the program, so a change to the program
cannot move what its kernels are measured against.

The counts were first written in the repo's chip_smoke.py (``k1_flops``,
``_bound``, ``_k2_times``); these are copies.
"""

import math

#: NVIDIA H100 SXM, dense (data sheet): float32 outside the tensor cores,
#: and HBM3 bandwidth. The port's default RAT_TPU_MATMUL_PRECISION is IEEE
#: float32, and K1 and K2 compute in float32 FMAs, adds and integer
#: compares, so the float32 rate is the one that bounds them.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(ops, nbytes):
    """The least time the card could take: the larger of the operation
    bound and the byte bound, in seconds."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def block_shape(cfg):
    """(t, s, d, heads, dim_head, hidden, project_out) of one encoder
    block on one example: 1 + K samples of F + 1 tokens."""
    d = cfg["embedding_dim"]
    t = 1 + cfg["dataset"]["retrieval"]["topK"]
    s = len(cfg["dataset"]["fields"]) + 1
    heads, dim_head = cfg["num_heads"], cfg["dim_head"]
    project_out = not (heads == 1 and dim_head == d)
    return t, s, d, heads, dim_head, d * cfg["scale_dim"], project_out


def k1_flops(t, s, d, heads, dim_head, hidden, project_out):
    """float32 operations of one block on one sample: the products
    (2 per multiply-add), plus LayerNorm (~8 per element), softmax (~5
    per score) and GELU (~10 per hidden unit)."""
    n, inner = t * s, heads * dim_head
    ops = 0
    for L in (s, t):
        ops += 2 * n * d * 3 * inner + 4 * n * L * inner + 5 * n * L * heads
        ops += 8 * n * d + (2 * n * inner * d if project_out else 0)
    return ops + 4 * n * d * hidden + 10 * n * hidden


def k1_bytes(batch, t, s, d, heads, dim_head, hidden, project_out):
    """Bytes one K1 launch must move: the block's input read and output
    written once, and its 14 weights read once."""
    inner = heads * dim_head
    weights = 2 * (2 * d + 3 * inner * d + (d * inner + d if project_out else 0))
    weights += hidden * d + hidden + d * hidden + d
    return 2 * batch * t * s * d * 4 + weights * 4


def k1_bound_s(cfg, batch):
    """The least time of one K1 launch over ``batch`` examples."""
    shape = block_shape(cfg)
    return bound_s(batch * k1_flops(*shape), k1_bytes(batch, *shape))


def forward_flops_per_example(cfg):
    """Model FLOPs of RAT_m2's forward on one example: the encoder
    blocks, the CLS head, the DNN tower over the target row's F x d
    embedding and the wide tower's F adds. Gathers count no operation."""
    n_fields = len(cfg["dataset"]["fields"])
    d = cfg["embedding_dim"]
    ops = cfg["depth"] * k1_flops(*block_shape(cfg)) + 2 * d
    dims = [n_fields * d] + list(cfg["dnn_hidden_units"]) + [1]
    ops += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return ops + (n_fields if cfg["use_wide"] else 0)


def train_flops_per_example(cfg):
    """The forward's FLOPs times 3 (forward, and a backward of about
    twice the forward); K1's forward recomputed inside the backward is
    not counted, since a model need not recompute it."""
    return 3 * forward_flops_per_example(cfg)


def fold_calls(n_rows, retrieval):
    """(queries, pool rows) of each K2 call that an X-fold
    self-retrieval of ``n_rows`` rows makes: each fold's rows against
    the other folds', cut into batches of ``qry_batch_size`` queries."""
    folds = int(retrieval["split_type"].split("-")[0])
    size = int(math.ceil(n_rows / folds))
    calls = []
    for fi in range(folds):
        q = max(0, min(n_rows, (fi + 1) * size) - fi * size)
        calls += pool_calls(q, n_rows - q, retrieval)
    return calls


def pool_calls(n_queries, n_pool, retrieval):
    """(queries, pool rows) of each K2 call of ``n_queries`` queries
    against a pool of ``n_pool`` rows."""
    step = retrieval["qry_batch_size"]
    return [(min(step, n_queries - lo), n_pool) for lo in range(0, n_queries, step)]


def k2_ops(queries, pool_rows, n_fields):
    """The dense scan's operations: one compare and one add per query,
    pool row and field. An algorithm that skips rows still counts them:
    a change to that algorithm needs the count redone here."""
    return 2 * queries * pool_rows * n_fields


def k2_bytes(queries, pool_rows, n_fields, topk):
    """The field-major pool read once, the queries and their IDF read,
    K (value, index) pairs written per query."""
    return n_fields * pool_rows * 4 + queries * n_fields * 8 + queries * topk * 8


def k2_bound_s(calls, n_fields, topk):
    """The least time of the K2 calls ``[(queries, pool rows), ...]``."""
    return sum(bound_s(k2_ops(q, n, n_fields), k2_bytes(q, n, n_fields, topk))
               for q, n in calls)
