"""The training step's share of the card's float32 peak in a cell of
its own configuration: ``train_mfu``'s reader, which reads the cell's
configuration (``yardstick.train_flops_per_example``: the forward's
FLOPs times 3) and the traced run's examples per second over its
window, less the profiler's stopping, over 67 TFLOP/s."""

from benchmarks import harness

read = harness.reader("train_mfu")
