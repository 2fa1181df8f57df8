"""Readings for the correctness limits: a cell's comparison numbers over
many seeds, the program's and the control's, in one process (one torch
start-up, the kernels loaded once).  Each seed still builds the cell from
scratch and runs a short window at the cell's own load and sizes.

    python3 benchmark/readings.py --workload seg4-serve-bulk --seconds 2 \\
        --seeds 11 12 13 --control-seeds 21 22 23 [--fault half_batch]

One JSON line per run: the seed, whether it ran the control, and every
number the comparison gave, the limits' and the others'.  The limits in
``benchmark/workloads/<cell>.json`` are set from these readings (above the
largest of the program's, below the smallest of the control's).
"""

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.faults import FAULTS  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant this fault in the program for every run")
    args = p.parse_args()

    import torch

    from benchmark import harness
    from benchmark.faults import Patches, plant

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        plant(Patches(), args.fault)
    runs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        numbers = {}
        r = harness.run(args.workload, seed, args.seconds, False, control=control,
                        numbers_out=numbers)
        print(json.dumps({"seed": seed, "control": control, "fault": args.fault,
                          "correct": r["correct"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "numbers": numbers}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
