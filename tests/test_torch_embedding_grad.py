"""The embedding lookups' backward (rat_tpu_torch/ops/embedding_grad.py,
csrc/embedding_grad.cu).

On the CPU: ``lookup`` is ``table[rows]`` in value and gradient bit for
bit, the autograd Function's backward (the card's path, with its plain
version in the kernel's place) too, and ``PackedEmbedding``,
``LabelEmbedding`` and ``LRLayer`` give the gradients of plain indexing.

On a card (skipped without one; there, without JAX, ``python -m pytest
--noconftest -m cuda tests/test_torch_embedding_grad.py``): the kernel against a float64
scatter-add at d = 1, 10 and 40 and other widths, over a 3-row table under
24,576 ids, a padding-heavy mix with a 30,000-long run of one id, and a
sparse mix that touches the first and last rows and leaves most rows
untouched; in float64 too, aligned and not; another dtype refused;
bit-equal over two calls and under CUDA-graph replay; a one-rank
``RowShardedLookup`` equal to the unsharded lookup. Gradients of
quarter-integers sum exactly in float32, so those cases compare exactly.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rat_tpu_torch import tracing
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.nn import embedding as emb_mod
from rat_tpu_torch.nn.embedding import (EmbeddingSpec, LabelEmbedding, PackedEmbedding,
                                        RowShardedLookup)
from rat_tpu_torch.nn.layers import LRLayer
from rat_tpu_torch.ops import embedding_grad as eg
from rat_tpu_torch.parallel.distributed import free_port

COUNTERS = ("embedding_grad.launches", "embedding_grad.captured")


@pytest.fixture
def one_thread():
    # torch's CPU index_put_ with accumulate adds a repeated id's rows in
    # an order that varies between threads: autograd of table[rows] is
    # bit-reproducible on one thread only
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _grad_of(fn, table, rows, cotangent):
    table = table.detach().clone().requires_grad_()
    out = fn(table, rows)
    (g,) = torch.autograd.grad(out, table, cotangent)
    return out.detach(), g


@pytest.mark.parametrize("rows_shape, num_rows, d", [
    ((4096, 6), 3, 10), ((8, 6, 17), 50, 40), ((300,), 1000, 1), ((0,), 5, 4)])
def test_cpu_lookup_is_plain_indexing(one_thread, rows_shape, num_rows, d):
    rng = np.random.RandomState(3)
    table = torch.from_numpy(rng.randn(num_rows, d).astype(np.float32))
    rows = torch.from_numpy(rng.randint(-num_rows, num_rows, rows_shape))
    cot = torch.from_numpy(rng.randn(*rows_shape, d).astype(np.float32))
    before = {k: tracing.counters()[k] for k in COUNTERS}
    want = _grad_of(lambda t, r: t[r], table, rows, cot)
    for fn in (eg.lookup, eg.Lookup.apply):
        got = _grad_of(fn, table, rows, cot)
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert torch.equal(_bits(eg.table_grad(cot, rows, num_rows)), _bits(want[1]))
    # nothing ran on a card, so no counter moved
    assert {k: tracing.counters()[k] for k in COUNTERS} == before


def _feature_map():
    fm = FeatureMap("emb_grad", ".")
    fm.feature_specs = {
        "user": {"type": "categorical", "vocab_size": 40, "index": 0},
        "gender": {"type": "categorical", "vocab_size": 3, "index": 1, "padding_idx": 0},
        "price": {"type": "numeric", "index": 2},
        "genre": {"type": "sequence", "vocab_size": 9, "index": [3, 4, 5], "max_len": 3,
                  "encoder": "MaskedSumPooling"},
        "artist": {"type": "sequence", "vocab_size": 12, "index": [6, 7, 8], "max_len": 3,
                   "encoder": "MaskedAveragePooling"},
    }
    fm.num_fields, fm.input_length = 5, 9
    return fm


def _grid(rng, shape):
    X = np.stack([rng.randint(0, v, shape) for v in (40, 3, 1, 9, 9, 9, 12, 12, 12)],
                 axis=-1)
    X[..., 4:6] = 8                     # genre padding (id vocab - 1)
    X[..., 8] = 11
    return (torch.from_numpy(X.astype(np.int64)),
            torch.from_numpy(rng.randn(*shape, 9).astype(np.float32)))


def _module_grads(module, inputs, cot):
    module.zero_grad()
    torch.autograd.backward(module(*inputs), cot)
    return {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("which", ["PackedEmbedding", "LabelEmbedding", "LRLayer"])
def test_cpu_modules_grads_unchanged(one_thread, monkeypatch, which):
    """Each module's gradients through ``lookup`` (plain indexing on the
    CPU) equal those through the autograd Function that the card takes,
    bit for bit."""
    rng = np.random.RandomState(5)
    gen = torch.Generator().manual_seed(5)
    if which == "LabelEmbedding":
        module = LabelEmbedding(10, generator=gen)
        labels = torch.from_numpy(rng.randint(0, 2, (4096, 6)))
        labels[:, 0] = 2
        inputs, out_shape = (labels,), (4096, 6, 10)
    elif which == "PackedEmbedding":
        module = PackedEmbedding(EmbeddingSpec.build(_feature_map(), 8), 8, generator=gen)
        inputs, out_shape = _grid(rng, (64, 6)), (64, 6, 5, 8)
    else:
        module = LRLayer(EmbeddingSpec.build(_feature_map(), 1, use_pretrain=False,
                                             force_dim=1), generator=gen)
        inputs, out_shape = _grid(rng, (64, 1)), (64, 1)
    cot = torch.from_numpy(rng.randn(*out_shape).astype(np.float32))
    plain = _module_grads(module, inputs, cot)
    monkeypatch.setattr(emb_mod, "lookup", eg.Lookup.apply)
    through = _module_grads(module, inputs, cot)
    assert plain.keys() == through.keys() and plain
    for name in plain:
        assert torch.equal(_bits(plain[name]), _bits(through[name])), name


# --- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the embedding backward's kernel runs on a CUDA card only")
    return torch.device("cuda", 0)


def _ids(mix, rng):
    """(rows, num_rows) of an id mix."""
    if mix == "label_table":
        # the label table: the MASK row once a sample, labels elsewhere
        rows = rng.randint(0, 2, (4096, 6))
        rows[:, 0] = 2
        return rows, 3
    if mix == "padding_heavy":
        # a sequence field's padding row takes 30,000 of 50,000 ids; runs
        # of 1 (fresh ids) and the first row besides
        num_rows = 5000
        rows = rng.zipf(1.05, 50_000) % (num_rows - 1)
        rows[rng.permutation(50_000)[:30_000]] = num_rows - 1
        rows[:100] = np.arange(100, 200)
        rows[100] = 0
        return rows.reshape(500, 100), num_rows
    # sparse: most rows untouched, the first and last present, negative
    # ids counted from the end
    num_rows = 100_000
    rows = rng.randint(0, num_rows, 20_000)
    rows[:3] = [0, num_rows - 1, -1]
    return rows, num_rows


def _scatter64(rows, grad, num_rows):
    want = np.zeros((num_rows, grad.shape[-1]))
    flat = rows.reshape(-1)
    np.add.at(want, np.where(flat < 0, flat + num_rows, flat),
              grad.reshape(-1, grad.shape[-1]).astype(np.float64))
    return want


def _case(card, mix, d, seed=7, values="quarters"):
    rng = np.random.RandomState(seed)
    rows, num_rows = _ids(mix, rng)
    shape = rows.shape + (d,)
    grad = (rng.randint(-8, 8, shape) / 4 if values == "quarters"
            else rng.randn(*shape)).astype(np.float32)
    return (torch.from_numpy(rows).to(card), torch.from_numpy(grad).to(card), num_rows,
            _scatter64(rows, grad, num_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 10, 40, 7, 200])
@pytest.mark.parametrize("mix", ["label_table", "padding_heavy", "sparse"])
def test_card_kernel_against_float64_scatter(card, mix, d):
    rows, grad, num_rows, want = _case(card, mix, d)
    before = eg.launches
    got = eg.table_grad(grad, rows, num_rows)
    torch.cuda.synchronize()
    assert eg.launches == before + 1
    got = got.cpu().numpy().astype(np.float64)
    # quarter-integers: every float32 sum is exact
    assert np.array_equal(got, want)
    untouched = np.ones(num_rows, bool)
    untouched[np.where(rows.cpu().numpy() < 0, rows.cpu().numpy() + num_rows,
                       rows.cpu().numpy()).reshape(-1)] = False
    assert (got[untouched] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["label_table", "padding_heavy"])
def test_card_kernel_rounding_and_unaligned_rows(card, mix):
    """Normal values: within float32 rounding of the float64 sum; a
    gradient that starts 4 bytes into its buffer (the kernel's scalar
    loads) gives the aligned call's bits."""
    rows, grad, num_rows, want = _case(card, mix, 40, values="normal")
    got = eg.table_grad(grad, rows, num_rows).cpu().numpy()
    scale = _scatter64(rows.cpu().numpy(), np.abs(grad.cpu().numpy()), num_rows)
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all()
    buf = torch.empty(grad.numel() + 1, dtype=torch.float32, device=card)
    shifted = buf[1:].view(grad.shape)
    shifted.copy_(grad)
    again = eg.table_grad(shifted, rows, num_rows)
    assert torch.equal(_bits(again), _bits(torch.from_numpy(got)))


@pytest.mark.cuda
def test_card_bits_repeat_and_replay(card):
    rows, grad, num_rows, _ = _case(card, "padding_heavy", 40, values="normal")
    first = eg.table_grad(grad, rows, num_rows)
    second = eg.table_grad(grad, rows, num_rows)
    assert torch.equal(_bits(first), _bits(second))
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        eg.table_grad(grad, rows, num_rows)       # warm-up on the capture's stream
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    captured = eg.captured
    with torch.cuda.graph(graph, stream=stream):
        replayed = eg.table_grad(grad, rows, num_rows)
    assert eg.captured == captured + 1
    replayed.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(replayed), _bits(first))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 10, 40, 7])
@pytest.mark.parametrize("offset", [0, 1])
def test_card_kernel_float64(card, d, offset):
    """A float64 gradient, its buffer aligned or one element in (the
    scalar loads), against the float64 scatter-add: quarter-integers sum
    exactly, as in float32."""
    rows, grad, num_rows, want = _case(card, "padding_heavy", d)
    buf = torch.empty(grad.numel() + offset, dtype=torch.float64, device=card)
    grad64 = buf[offset:].view(grad.shape)
    grad64.copy_(grad)
    before = eg.launches
    got = eg.table_grad(grad64, rows, num_rows)
    torch.cuda.synchronize()
    assert eg.launches == before + 1 and got.dtype == torch.float64
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_card_lookup_runs_the_kernel_or_refuses(card):
    """A float32 or float64 table's backward runs the kernel, with the
    value of indexing; another dtype's is refused."""
    rng = np.random.RandomState(2)
    rows = torch.from_numpy(rng.randint(0, 3, (4096, 6))).to(card)
    for dtype in (torch.float32, torch.float64):
        table = torch.from_numpy(rng.randn(3, 10)).to(card, dtype)
        cot = torch.from_numpy(rng.randn(4096, 6, 10)).to(card, dtype)
        before = tracing.counters()["embedding_grad.launches"]
        got = _grad_of(eg.lookup, table, rows, cot)
        want = _grad_of(lambda t, r: t[r], table, rows, cot)
        assert tracing.counters()["embedding_grad.launches"] == before + 1
        assert torch.equal(got[0], want[0])
        assert torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
    table = torch.zeros(3, 10, dtype=torch.float16, device=card)
    with pytest.raises(TypeError, match="float32 or float64"):
        _grad_of(eg.lookup, table, rows, torch.ones(4096, 6, 10, dtype=torch.float16,
                                                    device=card))


@pytest.mark.cuda
def test_card_one_rank_row_sharded_equals_unsharded(card):
    if dist.is_initialized():
        pytest.skip("a process group is open already")
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{}".format(free_port()),
                            world_size=1, rank=0, device_id=card)
    try:
        rows, grad, num_rows, _ = _case(card, "padding_heavy", 40, values="normal")
        table = torch.from_numpy(np.random.RandomState(4).randn(num_rows, 40)
                                 .astype(np.float32)).to(card)
        plain = _grad_of(eg.lookup, table, rows, grad)
        sharded = _grad_of(lambda t, r: RowShardedLookup.apply(t, r, 0, None), table, rows,
                           grad)
        torch.cuda.synchronize()
        assert torch.equal(_bits(plain[0]), _bits(sharded[0]))
        assert torch.equal(_bits(plain[1]), _bits(sharded[1]))
    finally:
        dist.destroy_process_group()
