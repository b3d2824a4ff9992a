"""Run a script as a small gloo world on the CPU, for the port's mesh
tests: n processes of ``python -c`` with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), one thread each, a
60 s process-group timeout and a time limit on the whole world, so that
a hung collective fails the test instead of eating the run. The ranks
can import the test modules (``tests`` is on their path)."""

import os
import subprocess
import sys
import time

from rat_tpu_torch.parallel.distributed import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import torch
torch.set_num_threads(1)
from rat_tpu_torch.parallel import initialize_distributed, make_mesh
initialize_distributed("cpu", timeout_s=60)
"""


def run_world(code, n, work_dir, timeout=150, prelude=PRELUDE):
    """Run ``prelude + code`` on ranks 0..n-1 in ``work_dir``; returns
    each rank's standard output. Raises with the failing ranks' errors
    if any rank fails, and kills the world at ``timeout`` seconds."""
    env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    procs, logs = [], []
    for rank in range(n):
        out = open(os.path.join(work_dir, "rank{}.out".format(rank)), "w+")
        err = open(os.path.join(work_dir, "rank{}.err".format(rank)), "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", prelude + code], cwd=work_dir, stdout=out,
            stderr=err, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        timed_out = [p for p in procs if p.poll() is None]
        for p in timed_out:
            p.kill()
            p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or failed:
        raise AssertionError("world of {} failed ({}): {}".format(
            n, "timeout {} s".format(timeout) if timed_out else failed,
            "\n".join("rank {}:\n{}".format(r, texts[r][1][-3000:]) for r, _ in failed)))
    return [t[0] for t in texts]
