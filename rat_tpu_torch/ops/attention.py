"""Softmax attention over short sequences from the packed QKV projection,
with a hand-written forward and backward on the card
(csrc/attention.cu).

``attention(qkv, heads, dim_head)`` takes ``qkv = F.linear(x, w_qkv)``,
[n, seq, 3 * inner] with q, k and v at columns [0, inner), [inner,
2 * inner) and [2 * inner, 3 * inner), head h the slice [h * dim_head,
(h + 1) * dim_head) of each, and returns the heads' softmax(q k^T *
dim_head ** -0.5) v side by side, [n, seq, inner], the layout the
out-projection reads. Where it runs (:func:`path`):

- CPU tensors: :func:`attention_reference`, the plain math of
  ``ops/cross_intra_block.py::attention``, under autograd;
- CUDA float32 tensors at a shape the kernel takes (:func:`takes`):
  :class:`AttentionFn`, whose forward and backward launch the kernel;
  the backward recomputes the softmax from the saved ``qkv`` and writes
  d(qkv) packed, with no float atomics, so every call gives the same
  bits, eager or replayed from a CUDA graph;
- other CUDA tensors: the plain version, counted in ``plain``.

The JAX package leaves this attention to XLA; the kernel was written for
the H100, where the plain version's batched products are hundreds of
thousands of cuBLAS products at 14 x 10 x 14 and 6 x 10 x 6.

Counters, as K1's (engine/step_graph.py adds a captured graph's calls
per replay): ``launches``, ``captured``, ``grad_launches``,
``grad_captured``, ``plain``.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build

#: forward kernel launches run on the card: each eager launch, and each
#: launch of a CUDA graph's replay (step_graph adds a graph's recorded
#: launches per replay)
launches = 0
#: forward launches recorded into CUDA graphs while they were captured; a
#: capture runs nothing, so these are not in ``launches``
captured = 0
#: backward kernel launches run on the card, counted as ``launches`` is
grad_launches = 0
#: backward launches recorded into CUDA graphs
grad_captured = 0
#: calls on CUDA tensors that ran the plain version because the kernel
#: does not take their dtype or shape (eager, captured, and per replay of
#: a graph that holds them)
plain = 0

#: the head width the kernel is compiled for (every configuration's),
#: the longest sequence it takes, the most (head, token) pairs of one
#: sequence, and the shared memory a block of one sequence's backward may
#: take on the H100 (csrc/attention.cu's ``takes``)
DIM_HEAD = 10
MAX_SEQ = 32
MAX_PAIRS = 512
MAX_SMEM = 232448

_fns = None


def _library():
    """(forward, backward) launch functions, their argument types set
    once: the op runs in every layer of every step."""
    global _fns
    if _fns is None:
        lib = _build.load("attention")
        fwd, bwd = lib.attention_fwd_launch, lib.attention_bwd_launch
        fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = fwd, bwd
    return _fns


def takes(seq, heads, dim_head):
    """Whether the kernel takes sequences of ``seq`` tokens in ``heads``
    heads of ``dim_head``: the backward of one sequence holds its q, k,
    v, dO and dQ rows and each head's P and dS (rows of an odd stride)
    in shared memory."""
    smem = 4 * seq * heads * (5 * dim_head + 2 * (seq | 1))
    return dim_head == DIM_HEAD and 1 <= seq <= MAX_SEQ and 1 <= heads \
        and seq * heads <= MAX_PAIRS and smem <= MAX_SMEM


def path(device_type, dtype, seq, heads, dim_head):
    """Where :func:`attention` runs a call: "cpu" (the plain version
    under autograd), "kernel", or "plain" (a CUDA call the kernel does
    not take, counted)."""
    if device_type != "cuda":
        return "cpu"
    if dtype == torch.float32 and takes(seq, heads, dim_head):
        return "kernel"
    return "plain"


def _heads_first(t, heads):
    n, s, _ = t.shape
    return t.reshape(n, s, heads, -1).transpose(1, 2)


def attention_reference(qkv, heads, dim_head):
    """The plain version: [n, seq, 3 * inner] -> [n, seq, inner]."""
    n, s, _ = qkv.shape
    q, k, v = (_heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
    dots = torch.matmul(q, k.transpose(-1, -2)) * dim_head ** -0.5
    out = torch.matmul(torch.softmax(dots, dim=-1), v)
    return out.transpose(1, 2).reshape(n, s, -1)


def attention_grad_reference(qkv, grad, heads, dim_head):
    """The kernel's backward in plain PyTorch: d(qkv) [n, seq, 3 * inner]
    from ``grad`` [n, seq, inner], the softmax recomputed from ``qkv``,
    dS = P o (dP - rowsum(P o dP)) with dP = dO V^T."""
    n, s, _ = qkv.shape
    scale = dim_head ** -0.5
    q, k, v = (_heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
    d_o = _heads_first(grad, heads)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(d_o, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    parts = (torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(-1, -2), q) * scale,
             torch.matmul(p.transpose(-1, -2), d_o))
    return torch.cat([t.transpose(1, 2).reshape(n, s, -1) for t in parts], dim=-1)


def _vec(t, width):
    """1 where the kernel may copy ``t``'s rows 16 bytes at a time."""
    return int(t.data_ptr() % 16 == 0 and t.shape[1] * width % 4 == 0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(name):
    global launches, captured, grad_launches, grad_captured
    capturing = torch.cuda.is_current_stream_capturing()
    if name == "forward":
        if capturing:
            captured += 1
        else:
            launches += 1
    elif capturing:
        grad_captured += 1
    else:
        grad_launches += 1


def _forward_kernel(qkv, heads, dim_head):
    n, s, width = qkv.shape
    out = torch.empty((n, s, width // 3), dtype=qkv.dtype, device=qkv.device)
    fwd, _ = _library()
    err = fwd(qkv.data_ptr(), out.data_ptr(), n, s, heads, dim_head, dim_head ** -0.5,
              _vec(qkv, width), _vec(out, width // 3), _stream(qkv))
    _build.check(err, "attention forward kernel")
    _count("forward")
    return out


def _backward_kernel(qkv, grad, heads, dim_head):
    n, s, width = qkv.shape
    grad = grad.contiguous()
    dqkv = torch.empty_like(qkv)
    _, bwd = _library()
    err = bwd(qkv.data_ptr(), grad.data_ptr(), dqkv.data_ptr(), n, s, heads, dim_head,
              dim_head ** -0.5, _vec(qkv, width), _vec(grad, width // 3),
              _vec(dqkv, width), _stream(qkv))
    _build.check(err, "attention backward kernel")
    _count("backward")
    return dqkv


class AttentionFn(torch.autograd.Function):
    """:func:`attention` on the kernel's path: on the card the forward
    and backward kernels; on the CPU (tests) :func:`attention_reference`
    and :func:`attention_grad_reference` in their place."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.dim_head = heads, dim_head
        if qkv.device.type == "cuda":
            return _forward_kernel(qkv, heads, dim_head)
        return attention_reference(qkv, heads, dim_head)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        qkv, = ctx.saved_tensors
        if qkv.device.type == "cuda":
            return _backward_kernel(qkv, grad, ctx.heads, ctx.dim_head), None, None
        return attention_grad_reference(qkv, grad, ctx.heads, ctx.dim_head), None, None


def attention(qkv, heads, dim_head):
    """Softmax attention of packed ``qkv`` [n, seq, 3 * heads * dim_head]
    -> [n, seq, heads * dim_head], scaled by dim_head ** -0.5; where it
    runs: :func:`path`."""
    global plain
    n, s, width = qkv.shape
    if width != 3 * heads * dim_head:
        raise ValueError("attention: qkv's last axis is {}, not 3 x {} heads x {}".format(
            width, heads, dim_head))
    route = path(qkv.device.type, qkv.dtype, s, heads, dim_head)
    if route == "kernel":
        return AttentionFn.apply(qkv.contiguous(), heads, dim_head)
    if route == "plain":
        plain += 1
    return attention_reference(qkv, heads, dim_head)
