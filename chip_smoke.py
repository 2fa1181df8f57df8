#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ugpg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ugpg_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at the
   stage-4 shapes, batch 8, in bfloat16 and in float32 (TF32 off for
   cuDNN and matmul).  Tolerance: max |kernel - plain| <= 1e-4 (float32)
   or 2e-2 (bfloat16: the double conv rounds its middle activation) times
   max(1, max |plain|).
4. Times each kernel at batch 64 in bfloat16 with CUDA events (warm-up,
   then the median of repeats) beside its plain version, one PyTorch
   library call computing the same function (cuDNN conv pair + ReLU,
   F.interpolate, the sigmoid expression; the port never calls these) and
   the card's bound for the work.
5. Serves stage 4 at full width through the port's entry points: seeded
   random weights with non-trivial BN stats saved as a reference-format
   .pth, Predictor(buckets=(1, 8, 64)), requests of 1, 5, 8 and 11 images
   in uint8 and float32, 16 concurrent BatchingServer submits, and
   images/s at bucket 64 in bfloat16 with a torch.profiler breakdown of
   one such call.  The launch counters, reset just
   before, must show 9 double-conv, 4 upsample and 1 uncertainty launches
   per device call.  A float32 GPU Predictor must agree with the same
   Predictor on device="cpu" (probabilities 1e-4).
6. Prints a "kernels" JSON line, then as its last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero without the last line.  Without
CUDA, or without the port next to this file, it fails at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")

from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor  # noqa: E402
from ugpg_tpu_torch.models.pgunet import PGUNet4  # noqa: E402
from ugpg_tpu_torch.ops.cuda import _lib  # noqa: E402
from ugpg_tpu_torch.ops.cuda.double_conv import (  # noqa: E402
    fused_double_conv,
    fused_double_conv_reference,
)
from ugpg_tpu_torch.ops.cuda.resize2x import upsample2x, upsample2x_reference  # noqa: E402
from ugpg_tpu_torch.ops.cuda.uncertainty import (  # noqa: E402
    uncertainty_from_logits,
    uncertainty_from_logits_reference,
)

CL = torch.channels_last
DEV = torch.device("cuda", 0)
# one H100 SXM (NVIDIA data sheet, dense): HBM 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
CHECK_BATCH, TIME_BATCH = 8, 64

# stage-4 shapes at full width: (H, Cin, Cm, Cout) of the 9 DoubleConvs in
# forward order, (C, H) of the 4 Up-block inputs, the logits' (K, H)
DOUBLE_CONVS = {
    "inc": (256, 3, 64, 64), "down1": (128, 64, 128, 128), "down2": (64, 128, 256, 256),
    "down3": (32, 256, 512, 512), "down4": (16, 512, 512, 512), "up1": (32, 1024, 256, 256),
    "up2": (64, 512, 128, 128), "up3": (128, 256, 64, 64), "up4": (256, 128, 64, 64),
}
UPSAMPLES = {"up1": (512, 16), "up2": (256, 32), "up3": (128, 64), "up4": (64, 128)}
LOGITS = (1, 256)

KERNELS = {
    "fused_double_conv": ("ugpg_tpu_torch/csrc/double_conv.cu",
                          "ugpg_tpu/ops/pallas/double_conv.py:196"),
    "upsample2x": ("ugpg_tpu_torch/csrc/upsample2x.cu", "ugpg_tpu/ops/pallas/resize2x.py:126"),
    "uncertainty_from_logits": ("ugpg_tpu_torch/csrc/uncertainty.cu",
                                "ugpg_tpu/ops/pallas/uncertainty_fused.py:66"),
}


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------- inputs
def dc_inputs(n, h, cin, cm, cout, dtype, g):
    x = torch.randn(n, cin, h, h, device=DEV, generator=g).to(dtype).contiguous(memory_format=CL)
    w1 = (torch.randn(cm, cin, 3, 3, device=DEV, generator=g) * (2 / (9 * cin)) ** 0.5).to(dtype)
    w2 = (torch.randn(cout, cm, 3, 3, device=DEV, generator=g) * (2 / (9 * cm)) ** 0.5).to(dtype)
    b1 = torch.randn(cm, device=DEV, generator=g) * 0.1
    b2 = torch.randn(cout, device=DEV, generator=g) * 0.1
    return x, w1, b1, w2, b2


def up_inputs(n, c, h, dtype, g):
    return (torch.randn(n, c, h, h, device=DEV, generator=g).to(dtype).contiguous(memory_format=CL),)


def unc_inputs(n, k, h, dtype, g):
    return ((torch.randn(n, k, h, h, device=DEV, generator=g) * 4).to(dtype),)


def library_double_conv(x, w1, b1, w2, b2):
    """cuDNN: the conv pair with ReLU in x's dtype (tensor cores in bf16)."""
    mid = F.relu(F.conv2d(x, w1, b1.to(x.dtype), padding=1))
    return F.relu(F.conv2d(mid, w2, b2.to(x.dtype), padding=1))


def library_upsample(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def library_uncertainty(x):
    return torch.sigmoid(x).sub_(0.5).abs_().mul_(-2.0).add_(1.0)


def cases():
    """(kernel, label, make_inputs(n, dtype, g), kernel fn, plain fn, library fn,
    bytes(n, itemsize), ops(n))."""
    out = []
    for name, (h, cin, cm, cout) in DOUBLE_CONVS.items():
        out.append((
            "fused_double_conv", name,
            lambda n, dt, g, s=(h, cin, cm, cout): dc_inputs(n, *s, dt, g),
            fused_double_conv, fused_double_conv_reference, library_double_conv,
            lambda n, sz, s=(h, cin, cm, cout): (
                n * s[0] * s[0] * (s[1] + s[3]) * sz + 9 * s[2] * (s[1] + s[3]) * sz
                + 4 * (s[2] + s[3])),
            lambda n, s=(h, cin, cm, cout): 2 * n * s[0] * s[0] * 9 * (s[1] * s[2] + s[2] * s[3]),
        ))
    for name, (c, h) in UPSAMPLES.items():
        out.append((
            "upsample2x", name, lambda n, dt, g, s=(c, h): up_inputs(n, *s, dt, g),
            upsample2x, upsample2x_reference, library_upsample,
            lambda n, sz, s=(c, h): 5 * n * s[0] * s[1] * s[1] * sz,
            lambda n, s=(c, h): 9 * 4 * n * s[0] * s[1] * s[1],
        ))
    k, h = LOGITS
    out.append((
        "uncertainty_from_logits", "logits", lambda n, dt, g: unc_inputs(n, k, h, dt, g),
        uncertainty_from_logits, uncertainty_from_logits_reference, library_uncertainty,
        lambda n, sz: 2 * n * k * h * h * sz,
        lambda n: 20 * n * k * h * h,
    ))
    return out


# ---------------------------------------------------------------- phases
def check_kernels():
    """Each kernel against its plain version, batch 8, bf16 and float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    g = torch.Generator(device=DEV).manual_seed(0)
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for kernel, label, make, fn, plain, _, _, _ in cases():
            args = make(CHECK_BATCH, dtype, g)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, (kernel, label)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            ok = err <= rel * max(1.0, scale)
            log(f"check {kernel:24s} {label:7s} {str(dtype)[6:]:9s} max_abs_err={err:.3e} "
                f"max|plain|={scale:.3e} tol={rel:g}x -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kernel} {label} {dtype}: {err} > {rel} * {scale}")
            if dtype == torch.bfloat16:
                worst[kernel] = max(worst.get(kernel, 0.0), err)
    return worst


def time_ms(fn, args, reps=3, repeats=5):
    fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def time_kernels():
    """Per-forward sums over the stage-4 shapes, batch 64, bf16."""
    dtype, n = torch.bfloat16, TIME_BATCH
    g = torch.Generator(device=DEV).manual_seed(1)
    totals = {}
    for kernel, label, make, fn, plain, library, nbytes, nops in cases():
        # the logits of the main path are float32 (the heads' dtype)
        args = make(n, torch.float32 if kernel == "uncertainty_from_logits" else dtype, g)
        t = {"ms": time_ms(fn, args), "plain_ms": time_ms(plain, args, reps=1, repeats=3),
             "library_ms": time_ms(library, args)}
        itemsize = 4 if kernel == "uncertainty_from_logits" else 2
        bytes_ms = nbytes(n, itemsize) / HBM_BYTES_PER_S * 1e3
        ops_ms = nops(n) / PEAK_OPS_PER_S[dtype if kernel == "fused_double_conv"
                                          else torch.float32] * 1e3
        t["bytes_ms"], t["ops_ms"] = bytes_ms, ops_ms
        log("time", json.dumps({"kernel": kernel, "shape": label, "batch": n,
                                **{k: round(v, 4) for k, v in t.items()}}))
        acc = totals.setdefault(kernel, dict.fromkeys(t, 0.0))
        for key, value in t.items():
            acc[key] += value
        del args
    torch.cuda.empty_cache()
    return totals


def random_checkpoint(path: Path, seed: int = 0) -> None:
    """Full-width stage-4 weights from a seed, He-scaled convs and
    non-trivial BN stats, as a reference-format container."""
    g = np.random.default_rng(seed)
    sd = {}
    for key, value in PGUNet4(use_bn=True).state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.int64)
            continue
        if value.dim() == 4:
            v = g.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith("running_var"):
            v = 1 + 0.2 * g.random(shape)
        elif key.endswith("weight"):  # BN scale
            v = 1 + 0.1 * g.standard_normal(shape)
        else:  # biases, running means
            v = 0.1 * g.standard_normal(shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    torch.save({"stage": 4, "epoch": 0, "model_state_dict": sd}, path)


def check_response(outs, n):
    preds, probs, unc = outs
    assert preds.shape == probs.shape == unc.shape == (n, 256, 256, 1), preds.shape
    assert np.isfinite(probs).all() and np.isfinite(unc).all()
    assert set(np.unique(preds)) <= {0.0, 1.0}
    assert probs.min() >= 0 and probs.max() <= 1 and unc.min() >= 0 and unc.max() <= 1
    np.testing.assert_allclose(unc, 1 - 2 * np.abs(probs - 0.5), atol=1e-5)


def profile_call(predictor, images):
    """Device time by kernel for one call (torch.profiler), and the share
    of the call's wall time the device sat idle."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(images)
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.key_averages():
        # device-side rows (kernels, copies) carry no CPU time; the
        # profiler's own buffer request is not the program's work
        if e.cpu_time_total == 0 and e.self_device_time_total > 0 \
                and e.key != "Activity Buffer Request":
            device[e.key] = device.get(e.key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:10]
    log("profile", json.dumps({
        "images": len(images), "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall_ms, "top_ms": {k[:90]: v for k, v in top}}))


def serve(tmp: Path):
    """The main path: stage-4 serving through Predictor and BatchingServer."""
    ckpt = tmp / "ug_pgunet_stage4_best.pth"
    random_checkpoint(ckpt)
    g = np.random.default_rng(1)
    images8 = g.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8)
    images = images8.astype(np.float32) / 255.0

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    pf = Predictor(str(ckpt), buckets=(1, 8, 64))
    p8 = Predictor(str(ckpt), buckets=(1, 8, 64), input_dtype=np.uint8)
    p32 = Predictor(str(ckpt), buckets=(2,), dtype=torch.float32)
    log(f"serve: predictors built in {time.perf_counter() - t0:.2f} s")

    for n in (1, 5, 8, 11):
        a, b = pf(images[:n]), p8(images8[:n])
        check_response(a, n)
        check_response(b, n)
        for u, v in zip(a, b):  # x/255 on the host == on the device
            np.testing.assert_array_equal(u, v)
    log("serve: requests of 1, 5, 8, 11 images (float32 and uint8) ok")

    server = BatchingServer(pf, max_latency_ms=20.0)
    try:
        futures = [server.submit(im) for im in images]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.close()
    direct = pf(images)
    for i, outs in enumerate(results):
        for got, want in zip(outs, direct):
            np.testing.assert_allclose(got, want[i], atol=1e-6)
    log("serve: 16 concurrent submits ok", json.dumps(server.stats()))

    big = np.concatenate([images] * 4)  # 64 images
    pf(big)  # warm
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        outs = pf(big)
    dt = time.perf_counter() - t0
    check_response(outs, 64)
    ips = reps * 64 / dt
    log(f"serve: bucket 64 bf16: {ips:.2f} images/s ({dt / reps * 1e3:.1f} ms per call)")
    profile_call(pf, big)

    g32 = p32(images[:2])
    counts = _lib.launch_counts()
    calls = sum(p.stats()["device_calls"] for p in (pf, p8, p32))
    expect = {"fused_double_conv": 9 * calls, "upsample2x": 4 * calls,
              "uncertainty_from_logits": calls}
    log(f"serve: {calls} device calls, launches {json.dumps(counts)}")
    assert counts == expect, (counts, expect)

    cpu = Predictor(str(ckpt), buckets=(2,), dtype=torch.float32, device="cpu")(images[:2])
    err = float(np.abs(g32[1] - cpu[1]).max())
    err_unc = float(np.abs(g32[2] - cpu[2]).max())
    flips = g32[0] != cpu[0]
    log(f"serve: float32 GPU vs CPU: max|dprob|={err:.3e} max|dunc|={err_unc:.3e} "
        f"pred flips={int(flips.sum())}")
    assert err <= 1e-4 and err_unc <= 1e-4
    assert np.all(np.abs(cpu[1][flips] - 0.5) < 1e-4)
    bf = pf(images[:2])[1]
    mean_err = float(np.abs(bf - cpu[1]).mean())
    log(f"serve: bf16 GPU vs float32 CPU: mean|dprob|={mean_err:.3e} "
        f"max|dprob|={float(np.abs(bf - cpu[1]).max()):.3e}")
    assert mean_err < 2e-2
    return counts, ips


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _lib.build()
    log(f"build: {len(_lib.SOURCES)} kernels in {time.perf_counter() - t0:.2f} s")

    errors = check_kernels()
    totals = time_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches, ips = serve(Path(tmp))

    rows = []
    for kernel, (source, replaces) in KERNELS.items():
        t = totals[kernel]
        bound = max(t["bytes_ms"], t["ops_ms"])
        rows.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": errors[kernel],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"],
        })
    log(f"serving: {ips:.2f} images/s, stage 4, bucket 64, bf16 on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
