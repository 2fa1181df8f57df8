"""Model FLOP/s utilization of training: images trained in the untraced
window x the train step's FLOP per image (3 x the stage's forward and the
frozen stage's forward, ``benchmark/counts``), over the window's seconds,
over the peak of the precision the convolutions run in (``train.peak``)."""

from benchmark import counts


def read(ctx):
    cfg, win = ctx["cell"].config, ctx["window"]
    if not ctx["on_chip"] or not win.work.get("images"):  # a peak of the card only
        return None
    flop = win.work["images"] * counts.train_flops(cfg)
    return 100.0 * flop / win.seconds / counts.PEAK_FLOPS[cfg["train"]["peak"]]
