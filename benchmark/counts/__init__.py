"""Operation and byte counts of the configurations' models and kernels, and
the chip's peaks: the yardstick the per-layer metrics divide by.

Every count is worked out from the shapes in a configuration file
(``benchmark/configs/*.json``), never from the program.  A model walks its
``blocks`` in order: ``inc`` at the configuration's resolution, each
``down*`` block after a 2x max-pool, each ``up*`` block at twice the size
of the one before; the 1x1 heads sit on the up blocks' outputs.  Every
DoubleConv is two 3x3 convolutions, its middle width its output width.

A DoubleConv's bound is the larger of its operations over the peak of the
precision it runs in and its bytes over the HBM bandwidth: each input,
weight and output byte counted once (the fp32 biases 4 bytes each).
"""

from __future__ import annotations

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): FLOP/s by precision
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12,
              "fp8": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bf16": 2, "fp16": 2, "tf32": 4, "fp32": 4, "fp8": 1, "int8": 1}


def double_convs(blocks: dict, resolution: int) -> list[tuple[str, int, int, int, int]]:
    """(name, side, C_in, C_mid, C_out) of each DoubleConv, in forward order."""
    out, side = [], resolution
    for name, (cin, cout) in blocks.items():
        if name.startswith("down"):
            side //= 2
        elif name.startswith("up"):
            side *= 2
        out.append((name, side, cin, cout, cout))
    return out


def head_sides(blocks: dict, resolution: int) -> list[int]:
    """The side of each up block's output, where the heads sit."""
    return [side for name, side, *_ in double_convs(blocks, resolution) if name.startswith("up")]


def dc_flops(n: int, side: int, cin: int, cmid: int, cout: int) -> float:
    return 2.0 * n * side * side * 9 * (cin * cmid + cmid * cout)


def dc_bytes(n: int, side: int, cin: int, cmid: int, cout: int, itemsize: int) -> float:
    return (n * side * side * (cin + cout) * itemsize + 9 * cmid * (cin + cout) * itemsize
            + 4 * (cmid + cout))


def segmentation_flops(blocks: dict, heads: dict, resolution: int, num_classes: int) -> float:
    """One image's forward: the DoubleConvs and the 1x1 heads."""
    convs = sum(dc_flops(1, *shape[1:]) for shape in double_convs(blocks, resolution))
    sides = head_sides(blocks, resolution) or [resolution]
    return convs + sum(2.0 * s * s * c * num_classes for s, c in zip(sides, heads.values()))


def classifier_flops(config: dict, passes: int = 1) -> float:
    """One image's encoder forward and ``passes`` passes of the MLP head."""
    convs = sum(dc_flops(1, *shape[1:])
                for shape in double_convs(config["blocks"], config["resolution"]))
    w = config["head"]["widths"]
    return convs + passes * sum(2.0 * a * b for a, b in zip(w, w[1:]))


def model_flops(config: dict, passes: int = 1) -> float:
    """FLOP of one image's served forward under ``config``."""
    if config["model"] == "herlev_classifier":
        return classifier_flops(config, passes)
    return segmentation_flops(config["blocks"], config["heads"], config["resolution"],
                              config["num_classes"])


def train_flops(config: dict) -> float:
    """FLOP of one image's train step: 3 x the stage's forward (forward,
    and the backward's two products) plus the frozen previous stage's
    forward at its own resolution."""
    prev = config["train"]["prev"]
    return 3.0 * model_flops(config) + segmentation_flops(
        prev["blocks"], prev["heads"], prev["resolution"], config["num_classes"])


def double_conv_bound_s(config: dict, n: int, precision: str) -> float:
    """The least time of one call's DoubleConvs at batch ``n``: per
    DoubleConv the larger of its operation and byte bounds, summed."""
    total = 0.0
    for _, side, cin, cmid, cout in double_convs(config["blocks"], config["resolution"]):
        total += max(dc_flops(n, side, cin, cmid, cout) / PEAK_FLOPS[precision],
                     dc_bytes(n, side, cin, cmid, cout, ITEMSIZE[precision]) / HBM_BYTES_PER_S)
    return total


def double_conv_launches(config: dict) -> int:
    """Kernel launches of one call's DoubleConvs: two per block."""
    return 2 * len(config["blocks"])
