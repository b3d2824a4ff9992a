"""The benchmark of rat_tpu_torch on the NVIDIA H100: its harness
(``harness.py``, entered through ``run.py``), configurations, traffic,
runners, per-layer metric readers, limits, yardstick and the plain
reference that decides ``correct``. It imports neither JAX nor the JAX
package; the reference imports nothing of rat_tpu_torch."""
