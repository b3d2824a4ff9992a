"""Entry of the benchmark of rat_tpu_torch; see benchmarks/harness.py.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmarks import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
