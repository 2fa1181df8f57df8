"""The numbers that decide ``correct``: each a gap between what the program
produced and what the reference works out, each held to its limit in
``benchmark/workloads/<cell>.json``.

Serving, segmentation (per pixel of the compared calls), each gap held
against the reference's own rounding to the configuration's bf16 body
(its convolutions' inputs and weights rounded to bfloat16, for these
weights and images), since how far rounding moves a probability differs
from seed to seed by up to 4x:
  ``max_ratio``  the largest |p - p_ref| over the largest |p_bf16 - p_ref|
  ``unc_ratio``  the same of the uncertainty maps u = 1 - 2|p - 0.5|
  ``preds_off``  pixels whose prediction is not ``p_ref > threshold`` though
                 p_ref lies further from it than ``max_ratio``'s limit x
                 the block's largest |p_bf16 - p_ref|
  and, not held to a limit: ``probs_gap``, ``unc_gap`` (the largest gaps)
Serving, classification (per image of the compared calls):
  ``probs_gap``  the largest |p - p_ref| over classes
  ``var_gap``    the largest |v - v_ref| of the MC-dropout variances
  ``labels_off`` images whose label is not the reference's, though the
                 reference's two best probabilities lie further apart than
                 twice the ``probs_gap`` limit
Training (the first steps, each leaf by name):
  ``loss_gap``   the largest |L - L_ref| / |L_ref| over the steps
  ``grad_gap``   the worst leaf's | |g| - |g_ref| | over the larger of
                 |g_ref| and the median leaf's |g_ref|, g the first step's
                 gradient as the optimizer used it (weight decay added)
  ``update_gap`` the same of the parameters' change over the steps
  ``bn_gap``     the same of the BN running statistics' change
  ``grad_ratio`` the median leaf's | |g| - |g_ref| | elementwise (its norm
                 over |g_ref|'s, ``magnitude_gap``), over the same of the
                 reference's first step in the configuration's own
                 precision: how far the program's first gradient lies
                 from the exact one, in units of what TF32 itself moves it
  Leaves whose reference gradient (before weight decay) is under a
  thousandth of the median leaf's (the conv biases under a train-mode BN)
  move by round-off alone: the gradient and update gaps leave them out.
  The worst-leaf gaps swing from seed to seed with the later steps'
  round-off, so a precision lower than the stated one shows in the steady
  ``grad_ratio``; the worst-leaf gaps catch a state that does not move.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference.models import uncertainty

# relative gaps below this are float32 round-off
ROUND_OFF = 1e-6

__all__ = ["SegGaps", "ClsGaps", "train_gaps", "magnitude_gap", "passes"]


class SegGaps:
    """Accumulates the segmentation numbers over blocks of images."""

    def __init__(self, threshold: float, ratio_limit: float):
        self.threshold, self.ratio_limit = threshold, ratio_limit
        self.numbers = {"max_ratio": 0.0, "unc_ratio": 0.0, "preds_off": 0}
        self.pixels = 0
        self.max = {"probs": 0.0, "unc": 0.0, "emu_probs": 0.0, "emu_unc": 0.0}

    def add(self, preds, probs, unc, ref_probs: torch.Tensor, emulated: torch.Tensor) -> None:
        """The program's (preds, probs, uncertainty), the reference's
        probabilities and those of the reference rounded to bfloat16."""
        dev = ref_probs.device
        ref_unc = uncertainty(ref_probs)
        gaps = {
            "probs": torch.as_tensor(probs, device=dev, dtype=torch.float32) - ref_probs,
            "unc": torch.as_tensor(unc, device=dev, dtype=torch.float32) - ref_unc,
            "emu_probs": emulated - ref_probs,
            "emu_unc": uncertainty(emulated) - ref_unc,
        }
        for k, g in gaps.items():
            self.max[k] = max(self.max[k], float(g.abs().max()))
        self.pixels += ref_probs.numel()
        # a decision may flip within the allowed error of the threshold
        margin = self.ratio_limit * float(gaps["emu_probs"].abs().max())
        d = torch.as_tensor(preds, device=dev).float() > 0.5
        sure = (ref_probs - self.threshold).abs() > margin
        n, m = self.numbers, self.max
        n["preds_off"] += int(((d != (ref_probs > self.threshold)) & sure).sum())
        n["max_ratio"] = m["probs"] / max(m["emu_probs"], 1e-30)
        n["unc_ratio"] = m["unc"] / max(m["emu_unc"], 1e-30)
        n["probs_gap"], n["unc_gap"] = m["probs"], m["unc"]


class ClsGaps:
    """Accumulates the classification numbers over blocks of images."""

    def __init__(self, margin: float):
        self.margin = margin
        self.numbers = {"probs_gap": 0.0, "var_gap": 0.0, "labels_off": 0}
        self.images = 0

    def add(self, labels, probs, var, ref_probs: torch.Tensor, ref_var: torch.Tensor) -> None:
        dev = ref_probs.device
        p = torch.as_tensor(probs, device=dev, dtype=torch.float32)
        v = torch.as_tensor(var, device=dev, dtype=torch.float32)
        lab = torch.as_tensor(labels, device=dev).long()
        n = self.numbers
        n["probs_gap"] = max(n["probs_gap"], float((p - ref_probs).abs().max()))
        n["var_gap"] = max(n["var_gap"], float((v - ref_var).abs().max()))
        top2 = ref_probs.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * self.margin
        n["labels_off"] += int(((lab != ref_probs.argmax(-1)) & sure).sum())
        self.images += p.shape[0]


def _worst_leaf(got: dict[str, float], want: dict[str, float], keep) -> tuple[float, str]:
    names = [k for k in want if keep(k)]
    if not names:
        return 0.0, ""
    median = statistics.median(want[k] for k in names)
    return max((abs(got[k] - want[k]) / max(want[k], median, 1e-30), k) for k in names)


def _median_leaf(got: dict, want: dict, keep) -> float:
    names = [k for k in want if keep(k)]
    return statistics.median(abs(got[k] - want[k]) / max(want[k], 1e-30) for k in names)


def train_gaps(program: dict, reference: dict, log=None) -> dict[str, float]:
    """``program`` and ``reference``: ``losses`` (per step), and per leaf
    the norms ``grads`` (first step, as the optimizer used it),
    ``updates`` (parameters' change) and ``bn`` (running statistics'
    change); the reference also ``raw`` (its first gradients before weight
    decay).  ``log`` gets the worst leaf of each gap."""
    raw = reference["raw"]
    median = statistics.median(raw.values())
    moving = {k for k, v in raw.items() if v >= 1e-3 * median}
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(program["losses"], reference["losses"], strict=True)]
    out = {"loss_gap": max(losses), "loss1_gap": losses[0]}
    for key, name, keep in (("grads", "grad_gap", moving.__contains__),
                            ("updates", "update_gap", moving.__contains__),
                            ("bn", "bn_gap", lambda k: True)):
        out[name], leaf = _worst_leaf(program[key], reference[key], keep)
        out[name + "_median"] = _median_leaf(program[key], reference[key], keep)
        if log is not None:
            log(f"info {name} worst leaf {leaf}: program {program[key].get(leaf)!r} "
                f"reference {reference[key].get(leaf)!r}")
    if log is not None:
        log(f"info losses program {program['losses']} reference {reference['losses']}; "
            f"{len(raw) - len(moving)} of {len(raw)} leaves left out")
    return out


def magnitude_gap(got: dict, want: dict, raw: dict) -> float:
    """The median over the moving leaves (as ``train_gaps`` picks them by
    ``raw``) of | |g| - |g_ref| | elementwise, its norm over |g_ref|'s:
    how far the first gradient's elements lie from the reference's."""
    median = statistics.median(raw.values())
    gaps = [float((got[k].double() - want[k].double()).norm() / want[k].double().norm())
            for k, v in raw.items() if v >= 1e-3 * median]
    return statistics.median(gaps)


def passes(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a missing number fails)."""
    return all(k in numbers and numbers[k] <= limit for k, limit in limits.items())
