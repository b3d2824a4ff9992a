"""The module encoder's attention (rat_tpu_torch/ops/attention.py,
csrc/attention.cu).

On the CPU: the op's plain path equals the attention core that
``nn.layers.Attention`` ran before the kernel (the code copied below) bit
for bit, and so does the module, output and gradients; the autograd
Function (the card's path, with the plain version and the kernel's
backward formulas in the kernel's place) passes ``gradcheck`` in float64,
and its backward formulas match autograd of the plain version; the shape
dispatch, and the counters through it (``plain`` counts a call on the
card at a shape the kernel refuses), step_graph's per-replay counts and
``tracing.counters()``.

On a card (skipped without one; there, without JAX, ``python -m pytest
--noconftest -m cuda tests/test_torch_attention_kernel.py``): the kernel
against the plain version at KKBox's intra and cross shapes, Tmall's 32
heads, one token, a sequence count and length that fill no block, the
longest sequence and the most (head, token) pairs taken, forward and
d(qkv) within K1's float32 tolerances; two calls bit-equal; a capture
and replay in a CUDA graph bit-equal to the eager call.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rat_tpu_torch import tracing
from rat_tpu_torch.engine import step_graph
from rat_tpu_torch.nn.layers import Attention
from rat_tpu_torch.ops import attention as attn

COUNTERS = ("launches", "captured", "grad_launches", "grad_captured", "plain")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One CPU thread, in this process and in the processes a test
    starts: six test workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _core_before_kernel(qkv, heads, dim_head):
    """The attention core of ``ops/cross_intra_block.py::attention`` as it
    stood before the kernel, between the QKV and output projections."""
    n, s, _ = qkv.shape
    q, k, v = qkv.chunk(3, dim=-1)

    def heads_first(t):
        return t.reshape(n, s, heads, -1).transpose(1, 2)

    q, k, v = heads_first(q), heads_first(k), heads_first(v)
    dots = torch.matmul(q, k.transpose(-1, -2)) * dim_head ** -0.5
    out = torch.matmul(torch.softmax(dots, dim=-1), v)
    return out.transpose(1, 2).reshape(n, s, -1)


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _qkv(rng, n, seq, heads, dim_head, dtype=np.float32, scale=2.0):
    return torch.from_numpy((scale * rng.randn(n, seq, 3 * heads * dim_head)).astype(dtype))


def _counts():
    return tuple(getattr(attn, k) for k in COUNTERS)


@pytest.mark.parametrize("n, seq, heads, dim_head", [
    (64, 14, 8, 10), (96, 6, 8, 10), (16, 9, 32, 10), (8, 24, 2, 10), (5, 1, 3, 4)])
def test_cpu_plain_path_is_the_old_core(n, seq, heads, dim_head):
    rng = np.random.RandomState(seq)
    qkv = _qkv(rng, n, seq, heads, dim_head).requires_grad_()
    cot = torch.from_numpy(rng.randn(n, seq, heads * dim_head).astype(np.float32))
    before = _counts()
    got = attn.attention(qkv, heads, dim_head)
    want = _core_before_kernel(qkv, heads, dim_head)
    assert torch.equal(_bits(got), _bits(want))
    g_got, = torch.autograd.grad(got, qkv, cot)
    g_want, = torch.autograd.grad(want, qkv, cot)
    assert torch.equal(_bits(g_got), _bits(g_want))
    # nothing ran on a card, so no counter moved
    assert _counts() == before


@pytest.mark.parametrize("heads, dim_head, dim", [(8, 10, 40), (2, 10, 10), (1, 10, 10)])
def test_cpu_module_unchanged(heads, dim_head, dim):
    """``Attention`` (the QKV projection, the op, the out-projection when
    there is one) gives the old function's output and gradients bit for
    bit."""
    rng = np.random.RandomState(heads)
    module = Attention(dim, heads=heads, dim_head=dim_head,
                       generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.randn(24, 7, dim).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.randn(24, 7, dim).astype(np.float32))

    def old(x):
        out = _core_before_kernel(F.linear(x, module.to_qkv.weight), heads, dim_head)
        return F.linear(out, module.to_out.weight, module.to_out.bias) \
            if module.project_out else out

    params = [x] + list(module.parameters())
    got, want = module(x), old(x)
    assert torch.equal(_bits(got), _bits(want))
    for a, b in zip(torch.autograd.grad(got, params, cot),
                    torch.autograd.grad(want, params, cot)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("n, seq, heads, dim_head", [(3, 5, 2, 4), (2, 1, 3, 2), (2, 7, 1, 3)])
def test_cpu_function_gradcheck(n, seq, heads, dim_head):
    qkv = _qkv(np.random.RandomState(n + seq), n, seq, heads, dim_head, np.float64, 1.0)
    assert torch.autograd.gradcheck(lambda t: attn.AttentionFn.apply(t, heads, dim_head),
                                    (qkv.requires_grad_(),))


@pytest.mark.parametrize("n, seq, heads, dim_head", [(32, 14, 8, 10), (48, 6, 8, 10)])
def test_cpu_backward_formulas_match_autograd(n, seq, heads, dim_head):
    """The kernel's backward in plain PyTorch (the softmax recomputed,
    dS = P o (dP - rowsum(P o dP))) against autograd of the plain
    version, in float64."""
    rng = np.random.RandomState(7)
    qkv = _qkv(rng, n, seq, heads, dim_head, np.float64).requires_grad_()
    cot = torch.from_numpy(rng.randn(n, seq, heads * dim_head))
    want, = torch.autograd.grad(attn.attention_reference(qkv, heads, dim_head), qkv, cot)
    got = attn.attention_grad_reference(qkv.detach(), cot, heads, dim_head)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    # the Function's forward is the plain version's
    assert torch.equal(attn.AttentionFn.apply(qkv, heads, dim_head),
                       attn.attention_reference(qkv, heads, dim_head))


@pytest.mark.parametrize("device, dtype, seq, heads, dim_head, route", [
    ("cpu", torch.float32, 14, 8, 10, "cpu"),
    ("cuda", torch.float32, 14, 8, 10, "kernel"),      # KKBox intra
    ("cuda", torch.float32, 6, 8, 10, "kernel"),       # KKBox cross
    ("cuda", torch.float32, 9, 32, 10, "kernel"),      # Tmall
    ("cuda", torch.float32, 24, 2, 10, "kernel"),      # RAT_m0's joint sequence
    ("cuda", torch.float32, 1, 8, 10, "kernel"),
    ("cuda", torch.float32, 32, 8, 10, "kernel"),      # the longest sequence
    ("cuda", torch.float32, 16, 32, 10, "kernel"),     # the most (head, token) pairs
    ("cuda", torch.float32, 33, 2, 10, "plain"),       # longer than MAX_SEQ
    ("cuda", torch.float32, 17, 32, 10, "plain"),      # more pairs than MAX_PAIRS
    ("cuda", torch.float32, 32, 16, 10, "plain"),      # the backward's shared memory
    ("cuda", torch.float32, 84, 8, 10, "plain"),       # RAT_m0's joint sequence at KKBox
    ("cuda", torch.float32, 14, 8, 12, "plain"),       # a head width not compiled
    ("cuda", torch.float32, 6, 8, 16, "plain"),
    ("cuda", torch.float64, 14, 8, 10, "plain"),
    ("cuda", torch.float16, 14, 8, 10, "plain")])
def test_path(device, dtype, seq, heads, dim_head, route):
    assert attn.path(device, dtype, seq, heads, dim_head) == route


_real_path = attn.path


def test_plain_calls_on_a_card_are_counted(monkeypatch):
    """A call the dispatch sends to the plain version on a card adds one
    to ``plain`` (and runs the plain version); on the CPU nothing counts;
    a width that is not 3 x heads x dim_head is refused."""
    for key in COUNTERS:
        monkeypatch.setattr(attn, key, getattr(attn, key))    # restored after
    qkv = _qkv(np.random.RandomState(1), 4, 40, 2, 10)
    want = attn.attention_reference(qkv, 2, 10)
    before = _counts()
    assert torch.equal(attn.attention(qkv, 2, 10), want)
    assert _counts() == before
    # the dispatch as it decides for a CUDA tensor: 40 tokens go plain
    monkeypatch.setattr(attn, "path", lambda device, *rest: _real_path("cuda", *rest))
    assert torch.equal(attn.attention(qkv, 2, 10), want)
    assert _counts() == before[:4] + (before[4] + 1,)
    assert tracing.counters()["attention.plain"] == before[4] + 1
    with pytest.raises(ValueError, match="3 x 3 heads x 10"):
        attn.attention(qkv, 3, 10)


class _Optimizer(object):
    def step(self):
        pass


class _Trainer(object):
    """What a StepGraph reads of its trainer in a CPU test."""

    device = torch.device("cpu")
    mesh = None
    optimizer = _Optimizer()

    def step_path(self):
        return "model.path.module"


class _Graph(object):
    def replay(self):
        pass


@pytest.mark.parametrize("kind, per_replay", [("train", (8, 8, 0)), ("eval", (8, 0, 2))])
def test_step_graph_replay_adds_attention_calls(monkeypatch, kind, per_replay):
    """Each replay adds the attention calls its capture recorded to the
    counters of calls run on the card: forward and backward launches,
    and plain calls."""
    for key in COUNTERS:
        monkeypatch.setattr(attn, key, getattr(attn, key))    # restored after
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    graph = step_graph.StepGraph(_Trainer(), kind, None, 4, None)
    graph.graph, graph.warm, graph.attn_per_replay = _Graph(), True, per_replay
    graph.outputs = (torch.zeros(()),) if kind == "train" else (torch.zeros(4),) * 2
    before = _counts()
    graph.run(torch.zeros((3, 4), dtype=torch.int64),
              torch.zeros(3) if kind == "train" else None)
    assert _counts() == (before[0] + 3 * per_replay[0], before[1],
                         before[2] + 3 * per_replay[1], before[3],
                         before[4] + 3 * per_replay[2])


# --- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the attention kernel runs on a CUDA card only")
    return torch.device("cuda", 0)


def _both(card, n, seq, heads, dim_head, seed=0):
    rng = np.random.RandomState(seed)
    qkv = _qkv(rng, n, seq, heads, dim_head).to(card).requires_grad_()
    cot = torch.from_numpy(rng.randn(n, seq, heads * dim_head).astype(np.float32)).to(card)

    def run(fn):
        out = fn(qkv, heads, dim_head)
        return out.detach(), torch.autograd.grad(out, qkv, cot)[0]

    return qkv, cot, run


CARD_SHAPES = [(24576, 14, 8, 10), (57344, 6, 8, 10), (24576, 9, 32, 10), (2000, 1, 8, 10),
               (3001, 13, 8, 10), (2003, 32, 8, 10), (1001, 16, 32, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, seq, heads, dim_head", CARD_SHAPES)
def test_card_kernel_against_plain(card, n, seq, heads, dim_head):
    _, _, run = _both(card, n, seq, heads, dim_head)
    before = _counts()
    out, grad = run(attn.attention)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2] + 1) + before[3:]
    want_out, want_grad = run(attn.attention_reference)
    # K1's float32 tolerances (tests/test_torch_cross_intra_block.py)
    assert torch.allclose(out, want_out, rtol=1e-4, atol=1e-5)
    assert torch.allclose(grad, want_grad, rtol=2e-3, atol=1e-4)
    again = run(attn.attention)
    assert torch.equal(_bits(again[0]), _bits(out))
    assert torch.equal(_bits(again[1]), _bits(grad))


@pytest.mark.cuda
@pytest.mark.parametrize("n, seq, heads, dim_head", [(24576, 14, 8, 10), (3001, 13, 8, 10)])
def test_card_graph_replay(card, n, seq, heads, dim_head):
    qkv, cot, run = _both(card, n, seq, heads, dim_head, seed=1)
    eager = run(attn.attention)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        run(attn.attention)                      # warm-up on the capture's stream
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    with torch.cuda.graph(graph, stream=stream):
        replayed = run(attn.attention)
    assert _counts() == (before[0], before[1] + 1, before[2], before[3] + 1, before[4])
    for t in replayed:
        t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(replayed[0]), _bits(eager[0]))
    assert torch.equal(_bits(replayed[1]), _bits(eager[1]))


@pytest.mark.cuda
def test_card_refused_shape_runs_plain(card):
    _, _, run = _both(card, 64, 40, 2, 10)
    before = _counts()
    out, grad = run(attn.attention)
    assert _counts() == before[:4] + (before[4] + 1,)
    want = run(attn.attention_reference)
    assert torch.equal(out, want[0]) and torch.equal(grad, want[1])
