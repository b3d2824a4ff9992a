"""Kernel K2: fused BM25 score + top-K over the pool, and its plain
PyTorch version.

Port of rat_tpu/ops/pallas/bm25_scan.py::bm25_topk_fused_pallas (both
of its grids). ``bm25_topk`` launches the CUDA kernel
(csrc/bm25_topk.cu) on CUDA tensors and runs ``bm25_topk_reference``
on CPU tensors; there is no other fallback.

Both return, for each query, the K pool rows with the highest score
``sum_f 1[qry[b,f] == dbT[f,c]] * idf[b,f]`` in the exact order
(score desc, pool index asc), rows at or past ``db_valid_len`` scoring
0 (or -inf with ``neg_pad``, plain version only). The zero-score drop to
index -1 is the caller's (retrieval/bm25.py::_finalize).
"""

import ctypes
import functools

import torch

from . import _build

#: kernel launches made by :func:`bm25_topk` (CUDA tensors only)
launches = 0

_C = ctypes.c_int
_P = ctypes.c_void_p


def bm25_topk_reference(qry, qry_idf, db_T, db_valid_len, topk,
                        chunk_size=65536, neg_pad=False):
    """Plain version. qry [B, F] int32, qry_idf [B, F] f32, db_T [F, C]
    int32 with C >= topk. Returns (values [B, K] f32, indices [B, K]
    int32).

    The pool is scored chunk by chunk, each field's term added in
    ascending field order. Each chunk's columns are appended, in index
    order, behind the running best K (all of lower index), and a STABLE
    descending sort keeps the first K: ties therefore resolve to the
    lowest pool index, the order of ``lax.top_k`` with the chunk-major
    merge of the JAX scan (``torch.topk`` promises no tie order).
    """
    B, F = qry.shape
    C = db_T.shape[1]
    if C < topk:
        raise ValueError("pool has {} rows < topk={}; pad it".format(C, topk))
    pad_score = float("-inf") if neg_pad else 0.0
    best_v = torch.empty((B, 0), dtype=torch.float32, device=qry.device)
    best_i = torch.empty((B, 0), dtype=torch.int64, device=qry.device)
    for c0 in range(0, C, chunk_size):
        c1 = min(c0 + chunk_size, C)
        scores = torch.zeros((B, c1 - c0), dtype=torch.float32, device=qry.device)
        for f in range(F):
            eq = qry[:, f, None] == db_T[f, None, c0:c1]
            scores = scores + eq.to(torch.float32) * qry_idf[:, f, None]
        col = torch.arange(c0, c1, device=qry.device)
        scores = torch.where(col[None, :] < db_valid_len, scores,
                             torch.full_like(scores, pad_score))
        cand_v = torch.cat([best_v, scores], dim=1)
        cand_i = torch.cat([best_i, col[None, :].expand(B, -1)], dim=1)
        v, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
        best_v = v[:, :topk]
        best_i = torch.gather(cand_i, 1, order[:, :topk])
    return best_v.contiguous(), best_i.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _geometry(B, C, slots, queries_per_cta, tile):
    """(parts, rows_per_part) for B queries against C pool rows: the
    pool is cut into parts of whole tiles (blockIdx.y), and the count is
    the one whose waves of ``slots`` resident CTAs (SMs x CTAs that fit
    on one) finish first, each CTA costing its rows plus about a tile of
    set-up. A pure function of its arguments; parts <= 65,535 (the
    grid's y limit), and the parts cover rows 0..C-1 exactly once."""
    q_tiles = -(-B // queries_per_cta)
    tiles = -(-C // tile)
    best = None
    for parts in range(1, min(tiles, 65535) + 1):
        rows = -(-tiles // parts) * tile
        if -(-C // rows) != parts:   # the same cut as a smaller count
            continue
        cost = -(-q_tiles * parts // slots) * (rows + tile)
        if best is None or cost < best[0]:
            best = (cost, parts, rows)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _occupancy(F, K, device_index):
    """(queries per CTA, resident CTA slots on the card) of the scan
    kernel that serves (F, K)."""
    lib = _build.load("bm25_topk")
    qpc, per_sm = _C(), _C()
    fn = lib.bm25_topk_occupancy
    fn.argtypes = [_C, _C, ctypes.POINTER(_C), ctypes.POINTER(_C)]
    fn.restype = _C
    with torch.cuda.device(device_index):
        _build.check(fn(F, K, ctypes.byref(qpc), ctypes.byref(per_sm)),
                     "bm25_topk occupancy")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return qpc.value, sms * per_sm.value


def bm25_topk(qry, qry_idf, db_T, db_valid_len, topk):
    """Dispatch on the tensors' device: CUDA -> kernel K2 (or raise),
    CPU -> :func:`bm25_topk_reference`."""
    if qry.device.type == "cpu":
        return bm25_topk_reference(qry, qry_idf, db_T, db_valid_len, topk)
    if qry.device.type != "cuda":
        raise ValueError("bm25_topk: unsupported device {}".format(qry.device))
    B, F = qry.shape
    C = db_T.shape[1]
    for name, t, dtype, shape in (("qry", qry, torch.int32, (B, F)),
                                  ("qry_idf", qry_idf, torch.float32, (B, F)),
                                  ("db_T", db_T, torch.int32, (F, C))):
        if t.device != qry.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("bm25_topk: {} must be a contiguous {} tensor of "
                             "shape {} on {}, got {} {} {}".format(
                                 name, dtype, shape, qry.device, t.dtype,
                                 tuple(t.shape), t.device))
    lib = _build.load("bm25_topk")
    if not 1 <= F <= lib.bm25_topk_max_fields():
        raise ValueError("bm25_topk: F={} outside 1..{}".format(
            F, lib.bm25_topk_max_fields()))
    if not 1 <= topk <= lib.bm25_topk_max_k():
        raise ValueError("bm25_topk: topk={} outside 1..{}".format(
            topk, lib.bm25_topk_max_k()))
    if C < topk:
        raise ValueError("pool has {} rows < topk={}; pad it".format(C, topk))
    out_v = torch.empty((B, topk), dtype=torch.float32, device=qry.device)
    out_i = torch.empty((B, topk), dtype=torch.int32, device=qry.device)
    dev = qry.device.index
    qpc, slots = _occupancy(F, topk, torch.cuda.current_device() if dev is None else dev)
    parts, rows = _geometry(B, C, slots, qpc, lib.bm25_topk_tile_rows())
    part_v = torch.empty((parts if parts > 1 else 0, topk, B),
                         dtype=torch.float32, device=qry.device)
    part_i = torch.empty_like(part_v, dtype=torch.int32)
    vec = C % 4 == 0 and db_T.data_ptr() % 16 == 0
    fn = lib.bm25_topk_launch
    fn.argtypes = [_P, _P, _P] + [_C] * 8 + [_P] * 5
    fn.restype = _C
    err = fn(qry.data_ptr(), qry_idf.data_ptr(), db_T.data_ptr(), B, F, C,
             int(db_valid_len), topk, parts, rows, int(vec), part_v.data_ptr(),
             part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
             torch.cuda.current_stream(qry.device).cuda_stream)
    _build.check(err, "bm25_topk kernel")
    global launches
    launches += 1
    return out_v, out_i
