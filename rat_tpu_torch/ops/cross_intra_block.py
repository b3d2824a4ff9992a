"""Kernel K1: one fused RAT_m2 cross/intra encoder block, and its plain
PyTorch version.

Port of rat_tpu/ops/pallas/cross_intra_block.py. ``cross_intra_block``
is differentiable (``CrossIntraBlock``, a ``torch.autograd.Function``,
the counterpart of the JAX ``custom_vjp``): its forward launches the
CUDA kernel (csrc/cross_intra_block.cu) on CUDA tensors and runs
``cross_intra_block_reference`` on CPU tensors, with no other fallback.
Its backward, on CUDA tensors, launches K1's backward kernel
(``k1_grad_kernel`` and ``k1_grad_sum_kernel`` in the same source): it
recomputes the block per sample from the saved inputs and writes dx and
the 14 weight gradients, deterministically. The JAX package has no
backward kernel (its ``_fused_bwd`` takes ``jax.vjp`` of the plain
math); this one was written for the H100. Where a shape does not take
the kernel (its widths, staged weights or per-warp area do not fit, as
at KKBox's d = 40), and on CPU tensors, the backward is autograd of the
plain version recomputed from the saved inputs, as JAX's is.

``x`` is [B, t, s, d] float32 as in the JAX package. ``params`` holds
the 14 weights of ``PARAM_ORDER`` in ``nn.Linear`` layout ([out, in]):
``w_qkv*`` [3*h*dh, d], ``w_out*`` [d, h*dh], ``ff_w1`` [hidden, d],
``ff_w2`` [d, hidden]. Without ``project_out`` (heads == 1 and
dim_head == d) the projection is skipped, and ``w_out*``/``b_out*`` may
be None.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

PARAM_ORDER = ("ln1_scale", "ln1_bias", "w_qkv1", "w_out1", "b_out1",
               "ln2_scale", "ln2_bias", "w_qkv2", "w_out2", "b_out2",
               "ff_w1", "ff_b1", "ff_w2", "ff_b2")

#: kernel launches run on the card by :func:`cross_intra_block` (CUDA
#: tensors only): each eager launch, and each launch of a CUDA graph's
#: replay (engine/step_graph.py adds a graph's recorded launches per replay)
launches = 0
#: launches recorded into CUDA graphs while they were captured; a capture
#: runs nothing, so these are not in ``launches``
captured = 0
#: backward calls on CUDA tensors that ran the backward kernel, counted as
#: ``launches`` is (step_graph adds a graph's recorded ones per replay)
grad_launches = 0
#: backward calls recorded into CUDA graphs by the backward kernel
grad_captured = 0
#: backward calls on CUDA tensors that took autograd of the plain block
#: because the kernel does not take their shape (eager, captured, and per
#: replay of a graph that holds them)
grad_plain = 0


def attention(x, w_qkv, w_out, b_out, heads, dim_head, project_out):
    """x [n, seq, d] -> [n, seq, d]: fused QKV (no bias), per-head
    softmax attention scaled by dim_head ** -0.5, out-projection."""
    n, s, _ = x.shape
    q, k, v = F.linear(x, w_qkv).chunk(3, dim=-1)

    def heads_first(t):
        return t.reshape(n, s, heads, -1).transpose(1, 2)

    q, k, v = heads_first(q), heads_first(k), heads_first(v)
    dots = torch.matmul(q, k.transpose(-1, -2)) * dim_head ** -0.5
    out = torch.matmul(torch.softmax(dots, dim=-1), v)
    out = out.transpose(1, 2).reshape(n, s, -1)
    if project_out:
        out = F.linear(out, w_out, b_out)
    return out


def cross_intra_block_reference(x, params, heads, dim_head, project_out=True):
    """Plain version of the block: intra attention over s, cross
    attention over t (each pre-LN, eps 1e-5, with residual), then the
    FF with exact GELU and no pre-norm."""
    p = params
    b, t, s, d = x.shape
    h = x.reshape(b * t, s, d)
    h = attention(F.layer_norm(h, (d,), p["ln1_scale"], p["ln1_bias"], 1e-5),
                  p["w_qkv1"], p["w_out1"], p["b_out1"], heads, dim_head,
                  project_out) + h
    h = h.reshape(b, t, s, d).transpose(1, 2).reshape(b * s, t, d)
    h = attention(F.layer_norm(h, (d,), p["ln2_scale"], p["ln2_bias"], 1e-5),
                  p["w_qkv2"], p["w_out2"], p["b_out2"], heads, dim_head,
                  project_out) + h
    ff = F.gelu(F.linear(h, p["ff_w1"], p["ff_b1"]), approximate="none")
    h = F.linear(ff, p["ff_w2"], p["ff_b2"]) + h
    return h.reshape(b, s, t, d).transpose(1, 2).contiguous()


def smem_bytes_per_sample(t, s, d, dim_head):
    """Shared memory the kernel needs for one sample (one warp's area)."""
    fn = _build.load("cross_intra_block").cross_intra_block_smem_per_sample
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(t, s, d, dim_head)


def _forward(x, params, heads, dim_head, project_out):
    """Dispatch on x's device: CUDA -> kernel K1 (or raise), CPU ->
    :func:`cross_intra_block_reference`."""
    if x.device.type == "cpu":
        return cross_intra_block_reference(x, params, heads, dim_head,
                                           project_out)
    if x.device.type != "cuda":
        raise ValueError("cross_intra_block: unsupported device {}".format(x.device))
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("cross_intra_block: x must be a contiguous float32 "
                         "[B, t, s, d] tensor, got {} {}".format(
                             x.dtype, tuple(x.shape)))
    B, t, s, d = x.shape
    inner = heads * dim_head
    if not project_out and inner != d:
        raise ValueError("project_out=False needs heads * dim_head == d")
    hidden = params["ff_w1"].shape[0]
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "w_qkv1": (3 * inner, d),
              "w_out1": (d, inner), "b_out1": (d,),
              "ln2_scale": (d,), "ln2_bias": (d,), "w_qkv2": (3 * inner, d),
              "w_out2": (d, inner), "b_out2": (d,),
              "ff_w1": (hidden, d), "ff_b1": (hidden,),
              "ff_w2": (d, hidden), "ff_b2": (d,)}
    ptrs = []
    for name in PARAM_ORDER:
        w = params.get(name)
        if w is None and not project_out and name[:5] in ("w_out", "b_out"):
            ptrs.append(None)
            continue
        if w is None or w.device != x.device or w.dtype != torch.float32 \
                or tuple(w.shape) != shapes[name] or not w.is_contiguous():
            raise ValueError("cross_intra_block: {} must be a contiguous "
                             "float32 tensor of shape {} on {}".format(
                                 name, shapes[name], x.device))
        ptrs.append(w.data_ptr())
    lib = _build.load("cross_intra_block")
    need = smem_bytes_per_sample(t, s, d, dim_head)
    limit = lib.cross_intra_block_max_smem_bytes()
    if need > limit:
        raise ValueError("cross_intra_block: one sample of shape t={} s={} d={} "
                         "heads={} dim_head={} needs {} bytes of shared memory, "
                         "above the {} a block may use".format(
                             t, s, d, heads, dim_head, need, limit))
    out = torch.empty_like(x)
    fn = lib.cross_intra_block_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), B, t, s, d, heads, dim_head, hidden,
             int(project_out), (ctypes.c_void_p * 14)(*ptrs),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "cross_intra_block kernel")
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


_grad_fns = None


def _grad_library():
    """(k1_grad_grid, k1_grad_launch) of the kernels' library, their
    argument types set once: the backward runs per block and step."""
    global _grad_fns
    if _grad_fns is None:
        lib = _build.load("cross_intra_block")
        grid, launch = lib.k1_grad_grid, lib.k1_grad_launch
        grid.argtypes = [ctypes.c_int] * 8
        launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        grid.restype = launch.restype = ctypes.c_int
        _grad_fns = grid, launch
    return _grad_fns


def _backward(x, weights, grad_out, heads, dim_head, project_out):
    """K1's backward kernel on CUDA tensors: (dx, [the gradient of each
    weight, None where the weight is None]), or None where the kernel
    does not take the shape. ``x`` and ``weights`` are the forward's
    checked inputs."""
    B, t, s, d = x.shape
    hidden = weights[PARAM_ORDER.index("ff_w1")].shape[0]
    grid_fn, launch = _grad_library()
    grid = grid_fn(B, t, s, d, heads, dim_head, hidden, int(project_out))
    if grid < 0:
        _build.check(-grid, "cross_intra_block backward's grid")
    if grid == 0:
        return None
    if grad_out.dtype != torch.float32 or grad_out.shape != x.shape:
        raise ValueError("cross_intra_block: grad_out must be float32 of shape {}, got "
                         "{} {}".format(tuple(x.shape), grad_out.dtype,
                                        tuple(grad_out.shape)))
    present = [w for w in weights if w is not None]
    sizes = [w.numel() for w in present]
    total = sum(sizes)
    grad_out = grad_out.contiguous()
    dx = torch.empty_like(x)
    partials = torch.empty((grid, total), dtype=torch.float32, device=x.device)
    flat = torch.empty(total, dtype=torch.float32, device=x.device)
    ptrs = [None if w is None else w.data_ptr() for w in weights]
    err = launch(x.data_ptr(), grad_out.data_ptr(), dx.data_ptr(), partials.data_ptr(),
                 flat.data_ptr(), B, t, s, d, heads, dim_head, hidden, int(project_out),
                 (ctypes.c_void_p * 14)(*ptrs), total, grid,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "cross_intra_block backward kernel")
    grads = iter(g.view_as(w) for g, w in zip(flat.split(sizes), present))
    return dx, [None if w is None else next(grads) for w in weights]


class CrossIntraBlock(torch.autograd.Function):
    """K1 under autograd. The 14 weights come in as separate inputs in
    ``PARAM_ORDER``, so that autograd reaches the module's parameters;
    ``w_out*``/``b_out*`` may be None (no ``project_out``) and get None
    gradients."""

    @staticmethod
    def forward(ctx, x, heads, dim_head, project_out, *weights):
        ctx.block = (heads, dim_head, project_out)
        ctx.save_for_backward(x, *weights)
        return _forward(x, dict(zip(PARAM_ORDER, weights)), heads, dim_head,
                        project_out)

    @staticmethod
    def backward(ctx, grad_out):
        global grad_launches, grad_captured, grad_plain
        x, *weights = ctx.saved_tensors
        if x.device.type == "cuda":
            got = _backward(x, weights, grad_out, *ctx.block)
            if got is not None:
                if torch.cuda.is_current_stream_capturing():
                    grad_captured += 1
                else:
                    grad_launches += 1
                return (got[0], None, None, None, *got[1])
            grad_plain += 1
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_()
                      for t in [x] + weights]
            out = cross_intra_block_reference(
                inputs[0], dict(zip(PARAM_ORDER, inputs[1:])), *ctx.block)
            present = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(out, present, grad_out))
        dx, *dw = [None if t is None else next(grads) for t in inputs]
        return (dx, None, None, None, *dw)


def cross_intra_block(x, params, heads, dim_head, project_out=True):
    """One block, differentiable in ``x`` and every weight of
    ``params``: the kernels on CUDA tensors (the backward's where it
    takes the shape, else autograd of the plain version), the plain
    version and its autograd on CPU tensors."""
    return CrossIntraBlock.apply(x, heads, dim_head, project_out,
                                 *(params.get(name) for name in PARAM_ORDER))
