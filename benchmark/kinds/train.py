"""Uncertainty-guided training at one stage: ``train_epoch`` over the port's
``DataLoader`` on an in-memory data set, epoch after epoch.

Mix parameters: ``batch``, ``dataset`` (tiles drawn from the seed),
``nuclei`` and ``radius`` (how many nuclei a tile holds and their radii in
pixels, each a [low, high] range), ``num_workers``, ``shuffle`` and
``check_steps`` (the first steps the reference follows).  The trainer runs
with its defaults.  The configuration gives the stage, its resolution, the
frozen previous stage and the optimizer.

Set-up builds one trainer, loads the seeded weights of the stage and of
the frozen stage from ``.pth`` files, and runs the first ``check_steps``
steps through ``train_epoch``, each on a loader over its own rows of the
data set (rows 0 to ``batch`` - 1, and so on), reading the losses, the
optimizer's state after the first step and the parameters and BN
statistics after the last.  The window hands that same trainer whole
epochs until ``seconds`` have passed, and ends on a synchronize.

End-to-end value: ``train_images_per_s``.  The control: the trainer's
bfloat16 path (``dtype=torch.bfloat16``), below the configuration's
float32 with TF32 convolutions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import Window, log, mark
from benchmark.kinds import Checkpoints, scaled_config
from benchmark.reference import compare
from benchmark.reference.models import exact, stated_precision
from benchmark.reference.train import reference_steps
from benchmark.weights import sub_seed


def nuclei_tiles(n: int, res: int, nuclei, radius, seed: int, device):
    """(images (n, res, res, 3) float32 in [0, 1], masks (n, res, res, 1)
    float32): pink tissue with purple nuclei (disks) and noise, drawn on
    ``device`` from ``seed``, returned as host arrays."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = nuclei[1]
    centres = torch.rand((n, k, 2), generator=g, device=device) * res
    radii = radius[0] + torch.rand((n, k), generator=g, device=device) * (radius[1] - radius[0])
    count = torch.randint(nuclei[0], nuclei[1] + 1, (n, 1), generator=g, device=device)
    radii = torch.where(torch.arange(k, device=device) < count, radii, torch.zeros_like(radii))
    noise = torch.rand((n, res, res, 3), generator=g, device=device)
    yy = torch.arange(res, device=device, dtype=torch.float32)
    masks = torch.empty((n, res, res, 1), device=device)
    for i in range(0, n, 64):  # a block of tiles at a time bounds the distance grid
        c, r = centres[i:i + 64], radii[i:i + 64]
        dy = (yy[None, None, :, None] - c[:, :, None, None, 0]) ** 2
        dx = (yy[None, None, None, :] - c[:, :, None, None, 1]) ** 2
        masks[i:i + 64, ..., 0] = ((dy + dx) < (r * r)[:, :, None, None]).any(1).float()
    tissue = torch.tensor([0.92, 0.72, 0.84], device=device)
    nucleus = torch.tensor([0.35, 0.22, 0.55], device=device)
    images = tissue + masks * (nucleus - tissue) + 0.15 * (noise - 0.5)
    return images.clamp(0, 1).cpu().numpy(), masks.cpu().numpy()


class Tiles:
    """A map-style data set over host arrays: (image, mask) per row."""

    def __init__(self, images: np.ndarray, masks: np.ndarray):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.masks[i]


def _norms(tensors) -> dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors}


def _first_gradient(square_avg, alpha: float) -> float:
    """|g| of a leaf from RMSprop's state after one step from zero,
    (1 - alpha) g^2; 0 where the optimizer holds no state for it."""
    if square_avg is None:
        return 0.0
    return float((square_avg.double().sum() / (1 - alpha)).sqrt())


def _magnitude(square_avg, alpha: float, param) -> torch.Tensor:
    """|g| elementwise from the same state (zeros where there is none), on the host."""
    if square_avg is None:
        return torch.zeros(param.shape)
    return (square_avg.double() / (1 - alpha)).sqrt().float().cpu()


class Training:
    def __init__(self, cell, seed: int, device: torch.device, scale: dict, control: bool):
        from ugpg_tpu_torch.data.loader import DataLoader
        from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer

        self.config = cfg = scaled_config(cell.config, scale)
        t = cell.traffic
        self.limits, self.device, self.seed = cell.limits, device, seed
        self.DataLoader = DataLoader
        self.stage, prev = cfg["stage"], cfg["train"]["prev"]
        self.batch = scale.get("batch", t["batch"])
        self.workers = t["num_workers"]
        self.ckpts = Checkpoints()
        p4 = self.ckpts.write("stage", cfg, sub_seed(seed, 0), device, self.stage)
        p3 = self.ckpts.write("prev", cfg, sub_seed(seed, 3), device, prev["stage"], prev)
        mark("weights")
        images, masks = nuclei_tiles(scale.get("dataset", t["dataset"]), cfg["resolution"],
                                     t["nuclei"], t["radius"], sub_seed(seed, 1), device)
        self.data = Tiles(images, masks)
        mark("data")
        self.loader = DataLoader(self.data, batch_size=self.batch, shuffle=t["shuffle"],
                                 num_workers=self.workers, seed=sub_seed(seed, 2))
        options = {}
        if "width" in scale:
            options["width"] = scale["width"]
        if "resolution" in scale:  # the CPU tests' smaller stages
            options["stage_configs"] = {
                s["stage"]: {"resolution": s["resolution"], "epochs_per_stage": 1,
                             "lr": cfg["train"]["optimizer"]["lr"]} for s in (cfg, prev)}
        if control:
            options["dtype"] = torch.bfloat16
        self.trainer = UncertaintyGuidedProgressiveTrainer(verbose=False, device=device,
                                                           **options)
        self.trainer.load_stage_weights(prev["stage"], str(p3))
        self.trainer.load_stage_weights(self.stage, str(p4))
        mark("trainer")
        self.program = self._first_steps(t["check_steps"])
        mark("first steps")

    def _first_steps(self, steps: int) -> dict:
        model = self.trainer.models[self.stage]
        alpha = self.config["train"]["optimizer"]["alpha"]
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        b0 = {k: v.detach().clone() for k, v in model.named_buffers()
              if k.endswith(("running_mean", "running_var"))}
        losses, grads = [], None
        for s in range(steps):
            rows = range(s * self.batch, (s + 1) * self.batch)
            part = Tiles(self.data.images[rows.start:rows.stop], self.data.masks[rows.start:rows.stop])
            loader = self.DataLoader(part, batch_size=self.batch, num_workers=self.workers)
            losses.append(self.trainer.train_epoch(loader, self.stage)[0])
            if grads is None:  # square_avg = (1 - alpha) g^2 after one step from zero
                state = self.trainer.optimizer.state
                grads = {k: _first_gradient(state[p].get("square_avg"), alpha)
                         for k, p in model.named_parameters()}
                self.magnitudes = {k: _magnitude(state[p].get("square_avg"), alpha, p)
                                   for k, p in model.named_parameters()}
        updates = _norms((k, v - p0[k]) for k, v in model.named_parameters())
        bn = _norms((k, v - b0[k]) for k, v in model.named_buffers() if k in b0)
        return {"losses": losses, "grads": grads, "updates": updates, "bn": bn,
                "rows": steps * self.batch}

    def window(self, seconds: float) -> Window:
        stats = self.trainer.loader_stats
        wait0, batches0 = stats["wait_s"], stats["batches"]
        images = epochs = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.trainer.train_epoch(self.loader, self.stage)
            images += len(self.data)
            epochs += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        batches = stats["batches"] - batches0
        return Window(elapsed, {"train_images_per_s": images / elapsed}, batches, 0,
                      {"images": images, "epochs": epochs, "steps": batches,
                       "wait_s": stats["wait_s"] - wait0})

    def release(self) -> None:
        self.trainer = None
        self.ckpts.close()

    def check(self) -> dict:
        cfg, prev = self.config, self.config["train"]["prev"]
        sd4 = Checkpoints.state_dict(cfg, sub_seed(self.seed, 0), self.device)
        sd3 = Checkpoints.state_dict(cfg, sub_seed(self.seed, 3), self.device, prev)
        n = self.program["rows"]
        batches = [(self.data.images[s:s + self.batch], self.data.masks[s:s + self.batch])
                   for s in range(0, n, self.batch)]
        with exact():
            ref = reference_steps(cfg, sd4, sd3, batches, self.device)
        # the yardstick: the reference's first step in the configuration's own precision
        with stated_precision(cfg["train"]):
            stated = reference_steps(cfg, sd4, sd3, batches[:1], self.device)
        p0 = dict(sd4)
        reference = {
            "losses": ref["losses"],
            "grads": _norms(ref["grads"].items()),
            "raw": _norms(ref["raw"].items()),
            "updates": _norms((k, v - p0[k]) for k, v in ref["params"].items()),
            "bn": _norms((k, v - p0[k]) for k, v in ref["buffers"].items()),
        }
        numbers = compare.train_gaps(self.program, reference, log)
        exact_g = {k: v.abs().cpu() for k, v in ref["grads"].items()}
        numbers["grad_elem"] = compare.magnitude_gap(self.magnitudes, exact_g, reference["raw"])
        numbers["grad_elem_stated"] = compare.magnitude_gap(
            {k: v.abs().cpu() for k, v in stated["grads"].items()}, exact_g, reference["raw"])
        numbers["grad_ratio"] = numbers["grad_elem"] / max(numbers["grad_elem_stated"],
                                                           compare.ROUND_OFF)
        return numbers


def make(cell, seed, device, scale, control):
    return Training(cell, seed, device, scale, control)
