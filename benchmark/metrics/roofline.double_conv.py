"""The bf16 double conv's share of its roofline: the calls seen in the
trace (``conv3x3_mma_kernel`` launches over the launches of one call)
times one call's DoubleConv bound (``benchmark/counts``: per DoubleConv the
larger of operations over the bf16 peak and bytes over HBM bandwidth),
over the kernel's summed device time."""

from benchmark import counts
from benchmark.harness import kernel_time

KERNEL = "conv3x3_mma_kernel"


def read(ctx):
    cfg, t = ctx["cell"].config, ctx["cell"].traffic
    seconds, launches = kernel_time(ctx, KERNEL)
    if not launches or seconds <= 0:
        return None
    calls = launches / counts.double_conv_launches(cfg)
    bound = calls * counts.double_conv_bound_s(cfg, t["batch"], cfg["serve"]["peak"])
    return 100.0 * bound / seconds
