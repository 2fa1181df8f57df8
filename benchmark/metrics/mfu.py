"""Model FLOP/s utilization of serving: images answered in the untraced
window x the model's FLOP per image with its MC-dropout head passes, if
any (``benchmark/counts``), over the window's seconds, over the peak of the
precision the body runs in (the configuration's ``serve.peak``)."""

from benchmark import counts


def read(ctx):
    cfg, win = ctx["cell"].config, ctx["window"]
    if not ctx["on_chip"] or not win.work.get("images"):  # a peak of the card only
        return None
    passes = ctx["cell"].traffic.get("mc_dropout") or 1
    flop = win.work["images"] * counts.model_flops(cfg, passes)
    return 100.0 * flop / win.seconds / counts.PEAK_FLOPS[cfg["serve"]["peak"]]
