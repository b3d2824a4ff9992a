"""The port's embedding lookups, ``table[rows]``, with a hand-written
backward on the card (csrc/embedding_grad.cu).

``lookup(table, rows)`` is ``table[rows]`` (a [num_rows, d] table, ids of
any shape). On CPU tensors it is exactly that, and autograd takes its
backward. On CUDA tensors it is :class:`Lookup`, whose forward is the
same gather and whose backward, :func:`table_grad`, writes the dense
table gradient with the kernel (float32 or float64; another dtype is
refused): it sorts the ids, sums each run of one id in segments of fixed
size and then each run's segments in order, with no float atomics, so
that every call gives the same bits, eager or replayed from a CUDA graph.
Its plain version, :func:`table_grad_reference`, is what autograd runs
for ``table[rows]`` (``index_put_`` with accumulate), whose CUDA kernel
gives each distinct id one warp that adds its rows one after another.

Counters, as K1's (engine/step_graph.py adds a captured graph's calls
per replay): ``launches``, ``captured``.
"""

import ctypes

import torch

from . import _build

#: backward calls on the card that ran the kernel: each eager call, and
#: each call of a CUDA graph's replay (step_graph adds a graph's recorded
#: calls per replay)
launches = 0
#: kernel calls recorded into CUDA graphs while they were captured; a
#: capture runs nothing, so these are not in ``launches``
captured = 0

#: the kernel's element size in bytes, by the gradient's dtype
_ELEM = {torch.float32: 4, torch.float64: 8}

_fns = None


def _library():
    """(workspace_bytes, launch) of the kernel's library, their argument
    types set once: the backward runs per lookup and step."""
    global _fns
    if _fns is None:
        lib = _build.load("embedding_grad")
        size, launch = lib.embedding_grad_workspace_bytes, lib.embedding_grad_launch
        size.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_longlong
        launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        _fns = size, launch
    return _fns


def table_grad_reference(grad, rows, num_rows):
    """The plain version: the [num_rows, d] gradient of ``table[rows]``
    from ``grad`` [*rows.shape, d], as autograd computes it."""
    width = grad.shape[-1]
    out = grad.new_zeros((num_rows, width))
    if num_rows:
        out.index_put_((rows.reshape(-1),), grad.reshape(-1, width), accumulate=True)
    return out


def table_grad(grad, rows, num_rows):
    """The [num_rows, d] gradient of ``table[rows]`` from ``grad``
    [*rows.shape, d]: the kernel on the card (float32 or float64), else
    :func:`table_grad_reference`."""
    global launches, captured
    if grad.device.type != "cuda":
        return table_grad_reference(grad, rows, num_rows)
    elem = _ELEM.get(grad.dtype)
    if elem is None:
        raise TypeError("embedding_grad: the kernel takes float32 or float64 "
                        "gradients, not {}".format(grad.dtype))
    width = grad.shape[-1]
    n = rows.numel()
    if n >= 1 << 31 or num_rows >= 1 << 31:
        raise ValueError("embedding_grad: {} ids into {} rows exceed 32-bit "
                         "indexing".format(n, num_rows))
    grad = grad.reshape(n, width).contiguous()
    rows = rows.reshape(n).to(grad.device, torch.int64).contiguous()
    size, launch = _library()
    nbytes = size(n, num_rows, width, elem)
    if nbytes < 0:
        _build.check(-nbytes, "embedding_grad's workspace")
    work = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=grad.device)
    out = torch.empty((num_rows, width), dtype=grad.dtype, device=grad.device)
    err = launch(rows.data_ptr(), grad.data_ptr(), out.data_ptr(), work.data_ptr(), nbytes,
                 n, num_rows, width, elem, torch.cuda.current_stream(grad.device).cuda_stream)
    _build.check(err, "embedding_grad kernel")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


class Lookup(torch.autograd.Function):
    """``table[rows]`` whose backward is :func:`table_grad`."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.num_rows = table.shape[0]
        return table[rows]

    @staticmethod
    def backward(ctx, grad):
        rows, = ctx.saved_tensors
        return table_grad(grad, rows, ctx.num_rows), None


def lookup(table, rows):
    """``table[rows]``: on the card through :class:`Lookup`, elsewhere
    the plain indexing."""
    if table.device.type != "cuda":
        return table[rows]
    return Lookup.apply(table, rows)
