"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from the window and from
a torch.profiler trace of a second window after it, with the traced
window's device busy and window seconds and a breakdown.  The last line of standard output is one JSON object; the
numbers compared against the plain reference, each beside its limit, are
the last lines of standard error and the result's last key.  Exits 2 and
prints no result without the CUDA cards the cell asks for, and 3 when a
JAX module was loaded.

``--control 1`` runs the cell's control in the program's place (the
comparison must then fail); the benchmark's own runs never set it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# kernel and compiler caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / "_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "benchmark" / "_cache" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", control=bool(args.control), t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"JAX modules loaded in the run's process: {found}")
        return 3
    checks = result.pop("checks")
    print(json.dumps({**result, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
