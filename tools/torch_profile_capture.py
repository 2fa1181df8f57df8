#!/usr/bin/env python3
"""How many launches of the port's kernels a torch.profiler window holds
in a fresh process, on one NVIDIA GPU: the two bucket-64 serving profiles
of ``chip_smoke.py`` (the seeded stage-4 ``Predictor`` and the seeded
Herlev classifier, bf16), each window taken ``--windows`` times.

    python3 tools/torch_profile_capture.py [--windows 6]

``chip_smoke.py`` takes each such profile through ``profile_kernel``,
which takes a window again while it holds fewer launches than one call
makes; this tool runs those calls alone, so the losses seen late in the
script's long process can be held against a process that has run nothing
else.  Prints the card's name and power limit, then one JSON line per
call: the launches of each kernel in each window.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from ugpg_tpu_torch.ops.cuda import _lib  # noqa: E402

KERNELS = ("conv3x3_mma_kernel", "conv3x3_f32_kernel", "uncertainty_kernel", "upsample")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--windows", type=int, default=6)
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _lib.build()
    smoke.native.build()
    profile_call = smoke.profile_call

    def windows(label, fn, kernel, launches):
        seen = []
        for _ in range(args.windows):
            device, wall_ms, counts = profile_call(label, fn)
            seen.append({k: sum(v for name, v in counts.items() if k in name) for k in KERNELS})
        print(json.dumps({"call": label, "launches_a_call": {kernel: launches},
                          "windows": seen}), flush=True)
        return device, wall_ms, counts, 1

    smoke.profile_kernel = windows
    with tempfile.TemporaryDirectory() as tmp:
        with smoke.tf32(False):
            smoke.serve(Path(tmp))
        smoke.serve_herlev(Path(tmp))


if __name__ == "__main__":
    main()
