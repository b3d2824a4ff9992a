"""The plain reference against the port on the CPU at the rehearsal
sizes: BM25 neighbours (X-fold and against a pool) exactly, and the
predictions through ``Trainer.predict`` within float32 rounding. The
training step's agreement is the rehearsal run's (test_ratbench_runs)."""

import os

import numpy as np
import pytest
import torch

from benchmarks import data, harness, program, weights
from benchmarks.runners import common
from benchmarks.reference import judge, rat
from benchmarks.tests.helpers import ROOT

CFG = harness.load_json(os.path.join(ROOT, "benchmarks", "configs", "rat_m2-mltag.json"))


@pytest.fixture(scope="module")
def splits():
    return data.splits(CFG, 123, rehearse=True)


@pytest.mark.parametrize("pool", [False, True], ids=["10-fold", "pool"])
def test_neighbours_equal_the_port(splits, pool):
    vocab, _, batch = data.sizes(CFG, True)
    fm = program.feature_map(CFG, vocab)
    rows = splits["valid"] if pool else splits["train"]
    gen = program.generator(CFG, fm, batch, "cpu", rows,
                            pool=splits["train"] if pool else None)
    ref = common.retrieval(CFG, rows, vocab, "cpu", pool=splits["train"] if pool else None)
    want = ref.run(np.arange(len(rows)))
    assert np.array_equal(common.answer(want).numpy(), gen.retr_indices)
    assert np.array_equal(want["scores"].numpy(), gen.retr_values.astype(np.float32))
    assert judge.neighbour_gap(want, ref.db, torch.from_numpy(gen.retr_indices),
                               torch.from_numpy(gen.retr_values)) == 0.0


def test_predictions_equal_the_port(splits):
    vocab, _, batch = data.sizes(CFG, True)
    fm = program.feature_map(CFG, vocab)
    gen = program.generator(CFG, fm, batch, "cpu", splits["test"], pool=splits["train"])
    trainer = program.BenchTrainer(fm, program.params(CFG, batch, 5, "unused"), device="cpu")
    w0 = weights.make(rat.param_spec(CFG, vocab), 7, "cpu", 0.05)
    program.load_weights(trainer, w0)
    got = trainer.predict(gen)
    rows = np.arange(len(splits["test"]))
    ids, labels = common.grid_inputs(rows, gen.retr_indices, splits["test"], splits["train"],
                                     "cpu")
    want = rat.predict(w0, ids, labels, CFG, rat.field_offsets(vocab, "cpu")).numpy()
    assert judge.prediction_gap(got, want) < 1e-6
    low = rat.predict(w0, ids, labels, CFG, rat.field_offsets(vocab, "cpu"),
                      dtype=common.CONTROL_DTYPE).numpy()
    assert judge.prediction_gap(low, want) > 1e-4


def test_weights_are_the_seed_s():
    spec = rat.param_spec(CFG, CFG["dataset"]["fields"])
    a = weights.make(spec, 2 ** 31 + 3, "cpu", 1e-4)
    b = weights.make(spec, 2 ** 31 + 3, "cpu", 1e-4)
    c = weights.make(spec, 2 ** 31 + 4, "cpu", 1e-4)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embedding_layer.table"], c["embedding_layer.table"])
    assert float(a["embedding_layer.table"].std()) == pytest.approx(1e-4, rel=0.01)
    assert torch.equal(a["encoder.blocks.0.intra_attention.norm.weight"], torch.ones(10))


def test_seeds_take_any_whole_number():
    big = data.seeds(2 ** 31 + 12345)
    assert big == data.seeds(2 ** 31 + 12345) and big != data.seeds(2 ** 31 + 12346)
    assert all(0 <= v < 2 ** 32 for v in big.values())
