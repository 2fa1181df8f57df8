"""Plain PyTorch reference of the uncertainty-guided train step at stage > 1:
the frozen previous stage's uncertainty map, the weighted BCE, the
gradient and torch-semantics RMSprop, float32 with TF32 off.  Nothing here
imports the port.

One step on a batch (NCHW images in [0, 1], masks in {0, 1}):

    p      = up(sigmoid(prev(down(x))))        prev in eval mode; down / up:
                                               bilinear resize, aligned corners
    A      = 1 - 2 |p - 0.5|
    l      = (1 - y) z + (1 + (pw - 1) y) log(1 + exp(-z))   per pixel, z = logits
    loss   = mean(l * (1 + alpha A))           (A carries no gradient)
    g      = d loss / d theta + wd * theta
    v      = a v + (1 - a) g^2
    theta -= lr * g / (sqrt(v) + eps)

with the model in train mode (BN on the batch's statistics, running
statistics updated once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import build, uncertainty

__all__ = ["weighted_bce", "RMSprop", "reference_steps"]


def weighted_bce(logits: torch.Tensor, y: torch.Tensor, probs_up: torch.Tensor,
                 pos_weight: float, alpha: float) -> torch.Tensor:
    pixel = F.binary_cross_entropy_with_logits(
        logits, y, pos_weight=torch.full((1,), pos_weight, device=logits.device),
        reduction="none")
    return (pixel * (1.0 + alpha * uncertainty(probs_up)).detach()).mean()


class RMSprop:
    """torch.optim.RMSprop without momentum, not centered, written out."""

    def __init__(self, params: list, lr: float, alpha: float, eps: float, weight_decay: float):
        self.params, self.lr, self.alpha, self.eps, self.wd = params, lr, alpha, eps, weight_decay
        self.square_avg = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> list[torch.Tensor]:
        """One update; returns the gradients it used (weight decay added)."""
        used = []
        for p, v in zip(self.params, self.square_avg):
            g = p.grad + self.wd * p
            v.mul_(self.alpha).add_((1.0 - self.alpha) * g * g)
            p.sub_(self.lr * g / (v.sqrt() + self.eps))
            used.append(g)
        return used


def reference_steps(config: dict, state4: dict, state3: dict, batches: list,
                    device) -> dict:
    """Run the configuration's train step over ``batches`` (a list of
    (images NHWC, masks NHWC) float32 numpy pairs) from ``state4`` with
    the frozen previous stage at ``state3``.  Returns the per-step losses,
    the first step's gradients before weight decay and as the optimizer
    used them (decay added), and the
    parameters and BN running statistics after the last step, by name."""
    train = config["train"]
    opt = train["optimizer"]
    model = build(config).to(device)
    model.load_state_dict(state4)
    prev = build(config, train["prev"]).to(device)
    prev.load_state_dict(state3)
    prev.eval()
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    optimizer = RMSprop(params, opt["lr"], opt["alpha"], opt["eps"], opt["weight_decay"])
    res, prev_res = config["resolution"], train["prev"]["resolution"]
    losses, first = [], None
    for images, masks in batches:
        x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2).contiguous()
        y = torch.as_tensor(masks, device=device).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            small = F.interpolate(x, size=(prev_res, prev_res), mode="bilinear",
                                  align_corners=True)
            probs_up = F.interpolate(torch.sigmoid(prev(small)), size=(res, res),
                                     mode="bilinear", align_corners=True)
        for p in params:
            p.grad = None
        loss = weighted_bce(model(x), y, probs_up, train["pos_weight"],
                            train["uncertainty_alpha"])
        loss.backward()
        if first is None:
            raw = {n: p.grad.detach().clone() for n, p in zip(names, params)}
        used = optimizer.step()
        if first is None:
            first = dict(zip(names, used))
        losses.append(loss.item())
    buffers = {n: b.detach().clone() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    return {"losses": losses, "grads": first, "raw": raw,
            "params": {n: p.detach().clone() for n, p in zip(names, params)},
            "buffers": buffers}
