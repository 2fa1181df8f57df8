#!/usr/bin/env python3
"""Time variants of the port's float32 conv kernel side by side on one GPU.

    python3 tools/torch_conv_f32_variants.py

Builds ``ugpg_tpu_torch/csrc/double_conv.cu`` as it stands and as a few text
variants of it (one ``nvcc`` each, all started together, ``-Xptxas -v``),
and prints for each variant the registers and spills of every
``conv3x3_f32_kernel`` instance and the static SASS opcode counts of the
BN 64 instance (``cuobjdump``).  Then, for the stage-4 DoubleConv shapes of
a 1008 px forward at batch 1 and down4 at 256 px, batch 8, it checks each
variant's float32 entry against ``fused_double_conv_reference`` (1e-4 x
max(1, max|plain|), TF32 off) and times it with CUDA events beside cuDNN's
pair, all in one process on one card.  Needs an NVIDIA GPU and the CUDA
toolkit; the card's name and power limit head the output.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ugpg_tpu_torch.ops.cuda import _lib  # noqa: E402
from ugpg_tpu_torch.ops.cuda.double_conv import (  # noqa: E402
    _ARGTYPES,
    f32_plan,
    fused_double_conv_reference,
    pack_double_conv,
)

ROLLED = "#pragma unroll 1\n    for (int c = 0; c < KC; ++c)"
RING = "constexpr int STAGES = 3;\nconstexpr int THREADS = 128;"
BOUNDS = "__launch_bounds__(THREADS, 3)"
# name -> (old, new) text substitutions in csrc/double_conv.cu
VARIANTS = {
    "as_is": [],
    "channel_loop_unrolled": [(ROLLED, "#pragma unroll\n    for (int c = 0; c < KC; ++c)")],
    "pitch_18": [("constexpr int PITCH = HW + 1;", "constexpr int PITCH = HW;")],
    "kc16_2_stages": [("constexpr int KC = 8;", "constexpr int KC = 16;"),
                      (RING, RING.replace("= 3;", "= 2;")),
                      (BOUNDS, "__launch_bounds__(THREADS, 2)")],
    "4_stages": [(RING, RING.replace("= 3;", "= 4;")), (BOUNDS, "__launch_bounds__(THREADS, 2)")],
}
# (N, H, Cin, Cm, Cout): stage 4 at 1008 px, batch 1, and down4 at 256 px, batch 8
SHAPES = [(1, 1008, 3, 64, 64), (1, 504, 64, 128, 128), (1, 252, 128, 256, 256),
          (1, 126, 256, 512, 512), (1, 63, 512, 512, 512), (1, 126, 1024, 256, 256),
          (1, 252, 512, 128, 128), (1, 504, 256, 64, 64), (1, 1008, 128, 64, 64),
          (8, 16, 512, 512, 512)]
DEV = torch.device("cuda", 0)


def build(out: Path) -> dict:
    src = (_lib.CSRC / "double_conv.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in double_conv.cu")
            text = text.replace(old, new)
        path = out / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_lib.CSRC),
             "-o", str(out / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{log[-4000:]}")
        for entry in log.split("Compiling entry function")[1:]:
            kernel = re.search(r"conv3x3_f32_kernelILi(\d)ELb(\d)E", entry)
            if kernel:
                regs = re.search(r"Used (\d+) registers", entry).group(1)
                spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
                print(f"{name}: BN {32 * int(kernel.group(1))}, "
                      f"{'16-byte' if kernel.group(2) == '1' else '4-byte'} staging: "
                      f"{regs} registers, {spill} bytes spilled")
        cuobjdump = Path(_lib._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(out / f"{name}.so")],
                              capture_output=True, text=True).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            if "conv3x3_f32_kernelILi2ELb1" in fn.splitlines()[0]:
                ops = {}
                for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", fn):
                    ops[op] = ops.get(op, 0) + 1
                top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
                print(f"{name}: static SASS of BN 64, 16-byte staging: {dict(top)}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).ugpg_double_conv_f32
        fn.argtypes, fn.restype = list(_ARGTYPES), ctypes.c_int
        entries[name] = fn
    return entries


def time_ms(fn, reps=3, repeats=5):
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_f32_variants: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp))
        totals = dict.fromkeys(["cudnn", *entries], 0.0)
        for n, h, cin, cm, cout in SHAPES:
            g = torch.Generator(device=DEV).manual_seed(h)
            x = torch.randn(n, cin, h, h, device=DEV, generator=g).contiguous(
                memory_format=torch.channels_last)
            w1 = torch.randn(cm, cin, 3, 3, device=DEV, generator=g) * (2 / (9 * cin)) ** 0.5
            w2 = torch.randn(cout, cm, 3, 3, device=DEV, generator=g) * (2 / (9 * cm)) ** 0.5
            b1 = torch.randn(cm, device=DEV, generator=g) * 0.1
            b2 = torch.randn(cout, device=DEV, generator=g) * 0.1
            w1k, b1k, w2k, b2k = pack_double_conv(w1, b1, w2, b2)
            mid = torch.empty((n, cm, h, h), device=DEV, memory_format=torch.channels_last)
            out = torch.empty((n, cout, h, h), device=DEV, memory_format=torch.channels_last)
            want = fused_double_conv_reference(x, w1, b1, w2, b2)
            bn1, bn2 = f32_plan(n, h, h, cm), f32_plan(n, h, h, cout)
            flop = 2 * n * h * h * 9 * (cin * cm + cm * cout)
            cudnn = time_ms(lambda: F.relu(F.conv2d(F.relu(F.conv2d(x, w1, b1, padding=1)), w2,
                                                    b2, padding=1)))
            totals["cudnn"] += cudnn
            line = [f"N={n} H={h} {cin}->{cm}->{cout}: cuDNN {cudnn:.3f} ms"]
            for name, fn in entries.items():
                def call(fn=fn):
                    _lib.check(fn(x.data_ptr(), w1k.data_ptr(), b1k.data_ptr(), mid.data_ptr(),
                                  w2k.data_ptr(), b2k.data_ptr(), out.data_ptr(), n, h, h, cin,
                                  cm, cout, bn1, bn2, _lib.stream(x)), "double_conv", name)
                call()
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                if err > 1e-4 * max(1.0, want.abs().max().item()):
                    raise SystemExit(f"variant {name} disagrees at {(n, h, cin, cm, cout)}: {err}")
                ms = time_ms(call)
                totals[name] += ms
                line.append(f"{name} {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s)")
            print(" | ".join(line), flush=True)
        print("totals (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in totals.items()))


if __name__ == "__main__":
    main()
