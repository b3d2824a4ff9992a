"""Benchmark capture of rat_tpu_torch (the port's counterpart of
bench.py): RAT_m2 training throughput and the secondary benches, each
as ONE JSON line.

    python bench_torch.py

Line 1 (headline): ML-Tag-shaped train throughput {"metric", "value",
"unit", "vs_baseline", "chip_health"}, stamped with the card's health
(rat_tpu_torch.cli.chip_health: round trip, per-launch cost, float32
matmul rate, small-width MHSA; card name and power limit), so that a
capture from a throttled or shared card labels itself.

Then the secondary lines, each from a killable subprocess of ``python
-m rat_tpu_torch.cli.benchmark`` with a per-bench budget
(RAT_TPU_BENCH_EACH_S, 150 s) inside a total budget counted from after
the headline (RAT_TPU_BENCH_BUDGET_S, 420 s): KKBox- and Tmall-shaped
train, ML-Tag eval, BM25 retrieval (200k pool, K2) and exact-match
retrieval. A bench skipped because the budget ran out is printed as
skipped; one that errors or times out makes the script exit non-zero.
The last line repeats the headline.

RAT_TPU_BENCH_HEADLINE_ONLY=1 prints only the headline;
RAT_TPU_BENCH_PALLAS=1 trains on the fused path (kernel K1). Runs on
card 0 and raises without one; RAT_TPU_PLATFORM=cpu asks for the CPU.
Workloads and baselines are rat_tpu_torch.cli.benchmark's.
"""

import json
import os
import subprocess
import sys
import time


def main():
    from rat_tpu_torch.cli import benchmark as bm
    from rat_tpu_torch.cli.chip_health import collect as chip_health

    device = "cpu" if os.environ.get("RAT_TPU_PLATFORM") == "cpu" else None
    use_pallas = os.environ.get("RAT_TPU_BENCH_PALLAS", "0") == "1"
    health = chip_health(device)
    headline = bm.bench_train(use_pallas=use_pallas, device=device)
    headline["chip_health"] = health
    print(json.dumps(headline), flush=True)
    if os.environ.get("RAT_TPU_BENCH_HEADLINE_ONLY") == "1":
        return 0
    # the budget counts from after the headline, so a slow headline never
    # eats the secondary lines' time
    t0 = time.time()
    budget = float(os.environ.get("RAT_TPU_BENCH_BUDGET_S", "420"))
    per_bench = float(os.environ.get("RAT_TPU_BENCH_EACH_S", "150"))
    secondary = [
        ("kkbox_train", ["--bench", "train", "--shape", "kkbox", "--steps", "256"]),
        ("tmall_train", ["--bench", "train", "--shape", "tmall", "--steps", "256"]),
        ("mltag_eval", ["--bench", "eval", "--shape", "mltag"]),
        ("retrieval", ["--bench", "retrieval"]),
        ("retrieval_exm", ["--bench", "retrieval_exm"]),
    ]
    n_ok, failed = 0, 0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for name, argv in secondary:
        left = budget - (time.time() - t0)
        if left < 30:
            print(json.dumps({"metric": name, "skipped": "time budget"}), flush=True)
            continue
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "rat_tpu_torch.cli.benchmark"] + argv,
                capture_output=True, text=True, env=env, timeout=min(per_bench, left))
            lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
            if proc.returncode == 0 and lines:
                print(lines[-1], flush=True)
                n_ok += 1
                continue
            error = (proc.stderr or "no output")[-200:]
        except subprocess.TimeoutExpired:
            error = "timeout after {:.0f} s".format(min(per_bench, left))
        failed += 1
        print(json.dumps({"metric": name, "error": error}), flush=True)
    # repeat the headline last: a reader may parse either end
    print(json.dumps(dict(headline, secondary_metrics_ok=n_ok)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
