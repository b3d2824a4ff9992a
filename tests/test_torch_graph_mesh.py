"""``dedup_neighbors``' fixed-size unique in the port against the JAX
package's, on the CPU.

The JAX gather dedups a batch's neighbour ids with
``jnp.unique(flat, return_inverse=True, size=flat.shape[0],
fill_value=0)`` (rat_tpu/engine/trainer.py::_gather_batch), so its step
has the shapes of the plain one. The port's ``fixed_size_unique`` is
held to that call: the same unique buffer (the sorted distinct ids, then
zeros) and the same inverse. The deduplicated gather is held bit for bit
to the plain gather and to the JAX package's
``_gather_batch(..., dedup_neighbors=True)``, token, label, numeric and
mask grids alike. The batches: all ids distinct, all equal, rows whose
missing neighbours (-1) the host maps to the pool's last row, and a
padded last batch; every case gives the same shapes. A rank's rows of
a step graph's static row buffer are a view of it.

The step graph's function under a process group is held to the per-step
mesh path in the 4-rank gloo world of tests/test_torch_parallel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rat_tpu.engine.trainer import _gather_batch as jax_gather
from rat_tpu_torch.data.loader import SplitBatches
from rat_tpu_torch.engine.trainer import _gather_batch, fixed_size_unique
from rat_tpu_torch.parallel import process_local_rows

B, K, F = 16, 5, 3
N_POOL = 200
N_ROWS = 96


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Split(SplitBatches):
    """``retr_indices`` [N_ROWS, K] over an N_POOL-row pool, -1 where a
    neighbour is missing; the host's gather ids come from
    SplitBatches.neighbor_gather_indices."""

    def __init__(self, retr):
        self.retr_indices = retr
        self.pool_darray = np.zeros((N_POOL, F + 1))


def _case(name):
    """(host split arrays, the batch's row ids) of one case."""
    rng = np.random.RandomState(7)
    retr = rng.randint(0, N_POOL, (N_ROWS, K))
    idx = rng.permutation(N_ROWS)[:B]
    if name == "distinct":
        retr[idx] = rng.permutation(N_POOL)[:B * K].reshape(B, K)
    elif name == "equal":
        retr[idx] = 37
    elif name == "wrapped":
        retr[idx[::2], 2:] = -1            # zero-score slots dropped upstream
    elif name == "padded":
        idx = np.concatenate([idx[:9], np.zeros(B - 9, idx.dtype)])
    split = _Split(retr)
    arrays = {
        "tokens": rng.randint(0, 50, (N_ROWS, F)),
        "labels": rng.randint(0, 2, N_ROWS).astype(np.float32),
        "numeric": rng.rand(N_ROWS, F).astype(np.float32),
        "pool_tokens": rng.randint(0, 50, (N_POOL, F)),
        "pool_labels": rng.randint(0, 2, N_POOL).astype(np.float32),
        "pool_numeric": rng.rand(N_POOL, F).astype(np.float32),
        "nbr": split.neighbor_gather_indices(),
        "nbr_ok": split.neighbor_valid_mask(),
    }
    return arrays, idx


CASES = ["distinct", "equal", "wrapped", "padded"]


def _torch_data(arrays):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in arrays.items()}


def _jax_data(arrays):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in arrays.items()}


@pytest.mark.parametrize("case", CASES)
def test_fixed_size_unique_matches_jnp_unique(case):
    arrays, idx = _case(case)
    nb = arrays["nbr"][idx]
    if case == "wrapped":
        assert (nb == N_POOL - 1).sum() >= B // 2 * (K - 2)
    unique, inverse = fixed_size_unique(torch.from_numpy(nb))
    want_unique, want_inverse = jnp.unique(nb.reshape(-1), return_inverse=True,
                                           size=nb.size, fill_value=0)
    assert unique.shape == (B * K,) and inverse.shape == (B, K)
    np.testing.assert_array_equal(unique.numpy(), np.asarray(want_unique))
    np.testing.assert_array_equal(inverse.numpy(), np.asarray(want_inverse).reshape(nb.shape))
    n_distinct = len(np.unique(nb))
    assert n_distinct == {"distinct": B * K, "equal": 1}.get(case, n_distinct)
    assert not unique[n_distinct:].any()
    assert torch.equal(unique[inverse], torch.from_numpy(nb))


@pytest.mark.parametrize("case", CASES)
def test_dedup_gather_equals_plain_and_jax_gather(case):
    """The deduplicated grids equal the plain gather's and the JAX
    package's deduplicated gather's bit for bit; so do the labels, the
    numeric values and the neighbour mask."""
    arrays, idx = _case(case)
    data = _torch_data(arrays)
    got = _gather_batch(data, torch.from_numpy(idx.astype(np.int64)), dedup_neighbors=True)
    plain = _gather_batch(data, torch.from_numpy(idx.astype(np.int64)))
    theirs = jax_gather(_jax_data(arrays), jnp.asarray(idx.astype(np.int32)),
                        dedup_neighbors=True)
    assert [tuple(t.shape) for t in got] == [(B, 1 + K, F), (B, 1 + K), (B, 1 + K, F),
                                             (B, 1 + K)]
    for ours, base, want in zip(got, plain, theirs):
        assert torch.equal(ours, base)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


def test_dedup_shapes_do_not_depend_on_the_ids():
    """Every case, whatever its number of distinct ids, gives the unique
    buffer, the inverse and the grids the same shapes and dtypes: a CUDA
    graph captured on one batch serves the next."""
    seen = set()
    for case in CASES:
        arrays, idx = _case(case)
        unique, inverse = fixed_size_unique(torch.from_numpy(arrays["nbr"][idx]))
        grids = _gather_batch(_torch_data(arrays), torch.from_numpy(idx.astype(np.int64)),
                              dedup_neighbors=True)
        seen.add(tuple((tuple(t.shape), t.dtype) for t in (unique, inverse) + grids))
    assert len(seen) == 1


@pytest.mark.parametrize("data, index", [(1, 0), (2, 1), (4, 3)])
def test_local_rows_are_a_view_of_the_static_row_buffer(data, index):
    """Under a mesh a captured step reads its rows through
    ``process_local_rows`` of the graph's static row buffer: a view, so
    that each replay sees the batch copied into the buffer before it."""

    class Mesh:
        pass

    mesh = Mesh()
    mesh.data, mesh.data_index = data, index
    buffer = torch.zeros(B, dtype=torch.int64)
    local = process_local_rows(buffer, mesh)
    buffer.copy_(torch.arange(B) + 100)
    per = B // data
    assert local._base is buffer and local.shape == (per,)
    assert torch.equal(local, torch.arange(index * per, (index + 1) * per) + 100)
