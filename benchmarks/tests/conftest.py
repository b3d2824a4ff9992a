"""The benchmark's tests (benchmarks/tests/). ``faults.FAULTS`` names,
by runner, the faults ``faults.plant`` plants; the runner
``train_masked`` is registered there with none, its faults being
``faults_masked.py``'s, so that the tests parametrised over every
cell's faults collect."""

from benchmarks.tests import faults, faults_masked

faults.FAULTS.setdefault(faults_masked.RUNNER, ())
