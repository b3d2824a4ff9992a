"""Running the harness in a child process, as a benchmark check does."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(args, cwd=ROOT, module=None, env=None, timeout=600):
    """(exit code, the last line of standard output as JSON or None,
    standard error) of ``benchmarks/run.py args`` (or ``python -m
    module args``) in ``cwd``."""
    cmd = [sys.executable] + (["-m", module] if module else
                              [os.path.join(cwd, "benchmarks", "run.py")]) + list(args)
    full_env = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                       env=full_env)
    lines = p.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except ValueError:
        last = None
    return p.returncode, last, p.stderr


def rehearse(cell, seed=11, seconds=1, extra=(), **kw):
    return run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                "--trace", "0", "--rehearse-cpu"] + list(extra), **kw)
