"""Find the knee of an open-loop cell: the highest offered rate whose
backlog does not grow over a window.  Run once when the cell's rate is
set (at about 4/5 of the knee), not by the benchmark's runs.

    python3 benchmark/knee.py --workload seg4-serve-open --seed 7 --seconds 8 \\
        --rates 400 600 800 1000 1200

One process, one set-up; each rate gets a window of its own.  Per rate one
JSON line: requests, the latency percentiles, the completed rate, and the
growth: the median latency of the window's last quarter of requests over
its first quarter's (about 1 while the backlog is flat).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="seg4-serve-open")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()

    import torch

    from benchmark import harness
    from benchmark.kinds import serve_open

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    runner = serve_open.make(cell, args.seed, torch.device("cuda"), {}, False)
    for rate in args.rates:
        runner.rate = rate
        win = runner.window(args.seconds)
        done = runner.last_latency_ms
        q = len(done) // 4
        print(json.dumps({
            "rate_per_s": rate, "requests": win.attempted, "failed": win.failed,
            "p50_ms": float(np.percentile(done, 50)), "p95_ms": float(np.percentile(done, 95)),
            "p99_ms": float(np.percentile(done, 99)),
            "completed_per_s": float(np.isfinite(done).sum() / win.work["span_s"]),
            "growth": float(np.median(done[-q:]) / np.median(done[:q])),
            "mean_group": win.work["submitted"] / win.work["groups"],
            "late_p95_ms": win.work["late_p95_ms"]}), flush=True)
    runner.release()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
