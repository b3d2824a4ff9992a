"""Kernel K3: dense BM25 scores of a query batch against one pool chunk,
and its plain PyTorch version.

Port of rat_tpu/ops/pallas/bm25_scan.py::bm25_score_chunk_pallas, the
score-only kernel (no top-K), reached through its own op
``bm25_score_chunk``. ``bm25_score_chunk`` launches the CUDA kernel
(csrc/bm25_score_chunk.cu) on CUDA tensors and runs
``bm25_score_chunk_reference`` on CPU tensors; there is no other
fallback.

Both return ``scores[b, c] = sum_f 1[qry[b,f] == db_chunk[c,f]] *
qry_idf[b,f]`` as [B, C] float32, the fields' terms added in ascending
field order, so the two give the same bits. The pool chunk is row-major
[C, F] (the JAX layout, unlike K2's field-major db_T). Unlike the Pallas
kernel, any B and C are taken: the kernel masks the ragged edge itself.
"""

import ctypes

import torch

from . import _build

#: kernel launches made by :func:`bm25_score_chunk` (CUDA tensors only)
launches = 0


def bm25_score_chunk_reference(qry, qry_idf, db_chunk):
    """Plain version. qry [B, F] int32, qry_idf [B, F] f32, db_chunk
    [C, F] int32 -> [B, C] f32."""
    B, F = qry.shape
    scores = torch.zeros((B, db_chunk.shape[0]), dtype=torch.float32,
                         device=qry.device)
    for f in range(F):
        eq = qry[:, f, None] == db_chunk[None, :, f]
        scores = scores + eq.to(torch.float32) * qry_idf[:, f, None]
    return scores


def bm25_score_chunk(qry, qry_idf, db_chunk):
    """Dispatch on the tensors' device: CUDA -> kernel K3 (or raise),
    CPU -> :func:`bm25_score_chunk_reference`."""
    if qry.device.type == "cpu":
        return bm25_score_chunk_reference(qry, qry_idf, db_chunk)
    if qry.device.type != "cuda":
        raise ValueError("bm25_score_chunk: unsupported device {}".format(qry.device))
    B, F = qry.shape
    C = db_chunk.shape[0]
    for name, t, dtype, shape in (("qry", qry, torch.int32, (B, F)),
                                  ("qry_idf", qry_idf, torch.float32, (B, F)),
                                  ("db_chunk", db_chunk, torch.int32, (C, F))):
        if t.device != qry.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("bm25_score_chunk: {} must be a contiguous {} tensor "
                             "of shape {} on {}, got {} {} {}".format(
                                 name, dtype, shape, qry.device, t.dtype,
                                 tuple(t.shape), t.device))
    lib = _build.load("bm25_score_chunk")
    if not 1 <= F <= lib.bm25_score_chunk_max_fields():
        raise ValueError("bm25_score_chunk: F={} outside 1..{}".format(
            F, lib.bm25_score_chunk_max_fields()))
    out = torch.empty((B, C), dtype=torch.float32, device=qry.device)
    fn = lib.bm25_score_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(qry.data_ptr(), qry_idf.data_ptr(), db_chunk.data_ptr(), B, F, C,
             out.data_ptr(), torch.cuda.current_stream(qry.device).cuda_stream)
    _build.check(err, "bm25_score_chunk kernel")
    global launches
    launches += 1
    return out
