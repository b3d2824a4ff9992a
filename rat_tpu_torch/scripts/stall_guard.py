"""Stall-guard supervisor for long runs: restart a child whose progress
files stop moving.

Runs a command in a process group of its own, watches a set of progress
artifacts (every file matching the ``--watch`` globs; a file that grows
or is rewritten counts as progress), and kills the whole group and
starts the command again whenever nothing has moved for
``--stall-secs``. The caches and the resumable retrieval slices
(data/loader.py::_PartialRetrievalStore) make a restart cheap. Exits
with the child's code when the child exits on its own: 0, or its
nonzero code after ``--max-restarts`` restarts. A supervisor that is
itself stopped (SIGTERM, an exception) kills the child's group first.

    python -m rat_tpu_torch.scripts.stall_guard --stall-secs 1500 \\
        --watch 'exps/rehearsal.log' --watch 'data/tmall*/**/*.npz' \\
        -- python -m rat_tpu_torch.scripts.tmall_rehearsal

The supervisor itself uses no device (``device`` is accepted and
ignored, like the other scripts' entry points take it); the child picks
its own.
"""

import argparse
import glob
import os
import signal
import subprocess
import sys
import time


def _progress_stamp(patterns):
    """Newest mtime and total size over all files matching the globs:
    either moving means the child is alive and working."""
    newest, total = 0.0, 0
    for pat in patterns:
        for p in glob.glob(pat, recursive=True):
            try:
                st = os.stat(p)
            except OSError:
                continue
            newest = max(newest, st.st_mtime)
            total += st.st_size
    return newest, total


def _kill_group(child):
    """Kill the child's process group unless the child has exited, and
    reap it."""
    if child.poll() is None:
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        child.wait()


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stall-secs", type=float, default=1500.0)
    ap.add_argument("--poll-secs", type=float, default=30.0)
    ap.add_argument("--max-restarts", type=int, default=20)
    ap.add_argument("--watch", action="append", required=True,
                    help="glob of progress artifacts (repeatable)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to supervise")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (use -- cmd ...)")

    # a supervisor stopped by SIGTERM (or an exception) takes its child
    # with it: the child's own process group would outlive it otherwise
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    restarts = 0
    while True:
        # a new process group, so that the kill takes the child's helpers
        # with it and nothing outside the child
        child = subprocess.Popen(cmd, start_new_session=True)
        try:
            sys.stderr.write("[stall_guard] started pid %d (restart %d)\n"
                             % (child.pid, restarts))
            last_stamp = _progress_stamp(args.watch)
            last_move = time.time()
            while True:
                try:
                    child.wait(timeout=args.poll_secs)
                    break
                except subprocess.TimeoutExpired:
                    pass
                stamp = _progress_stamp(args.watch)
                now = time.time()
                if stamp != last_stamp:
                    last_stamp, last_move = stamp, now
                elif now - last_move > args.stall_secs:
                    sys.stderr.write(
                        "[stall_guard] no artifact progress for %.0fs — "
                        "killing pid %d\n" % (now - last_move, child.pid))
                    break
        finally:
            _kill_group(child)
        if child.returncode == 0:
            sys.stderr.write("[stall_guard] child finished ok\n")
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            sys.stderr.write("[stall_guard] giving up after %d restarts\n"
                             % args.max_restarts)
            return child.returncode or 1
        time.sleep(5.0)


if __name__ == "__main__":
    sys.exit(main())
