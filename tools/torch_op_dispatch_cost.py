#!/usr/bin/env python3
"""Host time per call of the three serving kernels through three bindings,
on one NVIDIA GPU:

* the ctypes wrapper called directly (``ops/cuda/{double_conv,resize2x,
  uncertainty}.py``), as the models called it before the operators;
* the operator the port registers (``ops/cuda/library.py``:
  ``torch.library.Library(..., "DEF")`` with ``impl``);
* the same wrapper behind the ``torch.library.custom_op`` decorator, with
  a fake implementation, defined here under another namespace.

    python3 tools/torch_op_dispatch_cost.py

Each case is timed as ``chip_smoke.py`` times host cost: a host clock
around 200 calls with no synchronise among them, the median of 7 such
runs, the three bindings in turns (A B C C B A) so that a drift of the
host does not favour one.  Shapes: the smallest stage-4 serving call of
each kernel, at bucket 1 in float32 (down4's double conv, 512 channels at
16 px; up1's upsample, 512 channels at 16 px; the 256 px logits), where
the device never holds the host back.  Prints one JSON line per kernel,
then the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if not torch.cuda.is_available():
    sys.exit("torch_op_dispatch_cost: CUDA is not available; this script needs an NVIDIA GPU")

from ugpg_tpu_torch.ops.cuda import _lib, library  # noqa: E402
from ugpg_tpu_torch.ops.cuda import double_conv, resize2x, uncertainty  # noqa: E402

DEV = torch.device("cuda", 0)
CL = torch.channels_last


def _custom_ops():
    """The three wrappers behind ``torch.library.custom_op`` (namespace
    ``ugpg_torch_alt``), with fake implementations as in library.py."""
    @torch.library.custom_op("ugpg_torch_alt::fused_double_conv", mutates_args=())
    def dc(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
           b2: torch.Tensor, pw1: torch.Tensor, pb1: torch.Tensor, pw2: torch.Tensor,
           pb2: torch.Tensor) -> torch.Tensor:
        return double_conv.fused_double_conv(x, w1, b1, w2, b2, packed=(pw1, pb1, pw2, pb2))

    @dc.register_fake
    def _(x, w1, b1, w2, b2, pw1, pb1, pw2, pb2):
        n, _, h, w = x.shape
        return torch.empty((n, w2.shape[0], h, w), dtype=x.dtype, device=x.device,
                           memory_format=CL)

    @torch.library.custom_op("ugpg_torch_alt::upsample2x", mutates_args=())
    def up(x: torch.Tensor) -> torch.Tensor:
        return resize2x.upsample2x(x)

    @up.register_fake
    def _(x):
        n, c, h, w = x.shape
        return torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                           memory_format=CL)

    @torch.library.custom_op("ugpg_torch_alt::uncertainty_from_logits", mutates_args=())
    def unc(logits: torch.Tensor) -> torch.Tensor:
        return uncertainty.uncertainty_from_logits(logits)

    @unc.register_fake
    def _(logits):
        return torch.empty_like(logits)

    return dc, up, unc


def host_us(fn, args, calls=200):
    """Host microseconds per call over ``calls`` calls, then a synchronise."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    _lib.build(("double_conv", "upsample2x", "uncertainty"))
    alt_dc, alt_up, alt_unc = _custom_ops()
    g = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randn(1, 512, 16, 16, device=DEV, generator=g).contiguous(memory_format=CL)
    w1 = torch.randn(512, 512, 3, 3, device=DEV, generator=g) * 0.02
    w2 = torch.randn(512, 512, 3, 3, device=DEV, generator=g) * 0.02
    b1 = torch.randn(512, device=DEV, generator=g)
    b2 = torch.randn(512, device=DEV, generator=g)
    pk = double_conv.pack_double_conv(w1, b1, w2, b2)
    logits = torch.randn(1, 1, 256, 256, device=DEV, generator=g)
    cases = {
        "fused_double_conv": (
            (lambda *a: double_conv.fused_double_conv(*a[:5], packed=a[5:]),
             library.fused_double_conv, alt_dc), (x, w1, b1, w2, b2, *pk)),
        "upsample2x": ((resize2x.upsample2x, library.upsample2x, alt_up), (x,)),
        "uncertainty_from_logits": ((uncertainty.uncertainty_from_logits,
                                     library.uncertainty_from_logits, alt_unc), (logits,)),
    }
    names = ("wrapper", "library_impl", "custom_op")
    for kernel, (fns, args) in cases.items():
        want = fns[0](*args)
        for fn in fns[1:]:
            assert torch.equal(fn(*args), want), kernel  # the same kernel behind each
        samples = {n: [] for n in names}
        for _ in range(7):
            for i in (0, 1, 2, 2, 1, 0):
                samples[names[i]].append(host_us(fns[i], args))
        row = {"kernel": kernel, "shape": list(args[0].shape)}
        for n in names:
            row[f"{n}_host_us"] = statistics.median(samples[n])
            row[f"{n}_spread_us"] = [min(samples[n]), max(samples[n])]
        print(json.dumps(row), flush=True)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
