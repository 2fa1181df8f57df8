"""The serving cells' comparison: the reference run over the images of the
answers kept from the window, in blocks of rows, float32 with TF32 off,
each answer held against it (``benchmark/reference/compare.py``).

``control`` (the classifier's): the answers compared are the reference's
own computed in float8 (``models.set_precision``) in the program's place.
The segmentation cells' control is the program's int8 path, which their
drivers set up.
"""

from __future__ import annotations

import copy

import torch

from benchmark.reference import compare, models

__all__ = ["segmentation", "classification"]


def _reference(config: dict, state_dict: dict, device) -> torch.nn.Module:
    model = models.build(config).to(device)
    model.load_state_dict(state_dict)
    return model.eval()


def _control(model: torch.nn.Module, control: bool):
    return models.set_precision(copy.deepcopy(model), "fp8") if control else None


def _nchw(images, device) -> torch.Tensor:
    return torch.as_tensor(images, device=device).permute(0, 3, 1, 2).float() / 255.0


@torch.no_grad()
def segmentation(config: dict, state_dict: dict, items: list, limits: dict, device,
                 block: int = 16) -> dict:
    """``items``: (uint8 images (n, H, W, 3), (preds, probs, uncertainty)
    each (n, H, W, K)) pairs."""
    model = _reference(config, state_dict, device)
    emu = models.set_precision(copy.deepcopy(model), "bf16")
    thr = config["serve"]["threshold"]
    gaps = compare.SegGaps(thr, limits["max_ratio"])
    with models.exact():
        for images, outs in items:
            for s in range(0, len(images), block):
                x = _nchw(images[s:s + block], device)
                probs = torch.sigmoid(model(x)).permute(0, 2, 3, 1)
                got = [o[s:s + block] for o in outs]
                gaps.add(*got, probs, torch.sigmoid(emu(x)).permute(0, 2, 3, 1))
    return {**gaps.numbers, "pixels": gaps.pixels}


@torch.no_grad()
def classification(config: dict, state_dict: dict, items: list, limits: dict, device,
                   passes: int, mc_seed: int, bucket: int, block: int = 16,
                   control: bool = False) -> dict:
    """``items``: (uint8 images (n, H, W, 3), (labels, probs, variance),
    row of the first image in its call) triples; the MC-dropout masks are
    drawn for a call of ``bucket`` rows."""
    model = _reference(config, state_dict, device)
    ctl = _control(model, control)
    gaps = compare.ClsGaps(limits["probs_gap"])
    with models.exact():
        for images, outs, row0 in items:
            for s in range(0, len(images), block):
                x = _nchw(images[s:s + block], device)
                rows = slice(row0 + s, row0 + s + x.shape[0])
                probs, var = model.mc_forward(x, passes, mc_seed, bucket, rows)
                got = [o[s:s + block] for o in outs]
                if ctl is not None:
                    p, v = ctl.mc_forward(x, passes, mc_seed, bucket, rows)
                    got = [p.argmax(-1), p, v]
                gaps.add(*got, probs, var)
    return {**gaps.numbers, "images": gaps.images}
