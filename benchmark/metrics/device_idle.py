"""The device's idle share in the untraced window: 1 less the kernel
seconds an image takes (the union of the traced window's kernel
intervals, copies and fills left out, over its images) times the untraced
window's images per second.  The profiler costs the host time at every
launch, so the traced window's own share would count that cost as idle;
and a copy into pageable memory lasts as long as the host takes, so only
kernels give device seconds per image that the host's speed leaves alone."""


def read(ctx):
    tr, win, traced = ctx["trace"], ctx["window"], ctx["traced"]
    if tr["kernel_s"] <= 0 or not traced.work.get("images") or not win.work.get("images"):
        return None
    kernel_per_image = tr["kernel_s"] / traced.work["images"]
    return 100.0 * (1.0 - kernel_per_image * win.work["images"] / win.seconds)
