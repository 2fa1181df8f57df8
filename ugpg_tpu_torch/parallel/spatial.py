"""Spatially sharded inference: a PGUNet stage on an image whose H (and W)
are split over the mesh, with 1-px halos exchanged between the shards
(counterpart of the inference half of ``ugpg_tpu/parallel/spatial.py``).

H shards over the ``axis`` mesh axis (``data``) and, when ``w_axis`` names
a second one, W over it: a 2-D grid, each shard on its own mesh position,
so each device holds H*W/(n_h*n_w) of every activation.  Why 1-px halos
suffice, as in the JAX package:

* A 3x3 conv needs one neighbour row or column.  The exchange runs in two
  phases: H halos first (rows across the shard's W range), then W halos of
  the H-extended blocks, which carry the diagonal corners.  A shard takes
  halos on its inner sides only and makes one ``conv3x3`` launch with the
  kernel's own zero padding, then crops the halo rows and columns: at the
  image's true edge the kernel's padding is the conv's zero padding, which
  is JAX's zero halo and valid conv (``_conv3x3_halo``).  The convs run on
  BN-folded weights in the forward's dtype (``SpatialWeights``), one
  launch each, so a halo goes in between a DoubleConv's two convs.
* The 2x2 max-pool needs none (each shard's extent stays even).
* Every resize is bilinear with ``align_corners=True``: two taps per
  output.  On a sharded axis output shard i reads input shard i's rows and
  one row on either side: the band of the global interpolation matrix that
  shard i applies to its halo-extended block (``_axis_resize_bands``,
  whose taps are checked statically), a float32 matmul as JAX's einsum
  (TF32 must stay off on the card).  The 2x upsample kernel cannot run on
  a sharded axis (its taps use the local size); an unsharded axis uses
  ``ops/resize.py``'s matrices.
* The 1x1 heads and the uncertainty tail are per pixel; the tail runs the
  uncertainty kernel on each shard (``spatial_predict``), then the shards
  gather to the mesh's first device.

Arbitrary slide sizes go through ``pad_to_divisible`` and
``spatial_predict(..., pad=True)``: zero-padded to ``shards * 2**pools``
per axis, inferred, the outputs cropped back.  The resizes' taps depend on
the padded size, so this equals the unsharded model on the same padded
image, cropped (``eval/slide.py::native_forward``), to float32 round-off:
the shards' convs may sum in another order than the whole image's.

Tensors are NCHW-logical; images and outputs are NHWC, as in the JAX
package.

The training half (``make_spatial_train_step``, ``make_spatial_eval_step``;
``finetune_native`` runs them): a native-resolution batch split over the
same grid, the model's own live-BN blocks run over the shards in
lock-step (``DoubleConv.forward_parts``), every conv a plain ``F.conv2d``
on the halo-extended shard (the hand-written conv has no backward; JAX's
train forward is XLA's too), the halo rows cropped after it.  The halo's
backward is autograd's: the gradient of a neighbour's row flows back
through its copy and ``narrow`` to the shard it came from, the pull of the
cotangent that JAX's transpose of the halo push gives.  BN takes the
statistics of the whole image and batch (``cross_replica_batch_norm``,
Chan's combination of the shards' moments, the running stats updated
once), and the loss and the metrics are global: per shard the loss path
of ``train/steps.py::shard_loss`` (``fused_loss``: the loss kernels,
once per shard) and the shards' means averaged, Dice from per-sample sums
over the shards.  A spatial step so trains the unsharded step's function
on the same image.  The frozen previous stage (the uncertainty source)
runs the inference half above, BN folded, one ``conv3x3`` launch per conv
and shard, on the image resized by half through the bands; JAX keeps
eval-mode BN there (folding is the port's design, held to 1e-4).  Over
several processes (``parallel/distributed.py``) each process runs this
step on its own images; BN, the loss, the metrics and the gradients are
those of every process's images, and halos never cross a process.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ugpg_tpu_torch.models.blocks import conv_part
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.models.pgunet import STAGE_BLOCKS, block_double_conv, stage_topology
from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.cuda.double_conv import pack_conv
from ugpg_tpu_torch.ops.quant import _conv_base
from ugpg_tpu_torch.ops.resize import _bilinear_ac_matrix, resize_bilinear_align_corners
from ugpg_tpu_torch.metrics.segmentation import grid_metrics
from ugpg_tpu_torch.parallel import distributed
from ugpg_tpu_torch.parallel.mesh import Mesh, tensor_device
from ugpg_tpu_torch.uncertainty import binary_uncertainty, shard_loss

__all__ = [
    "SpatialWeights",
    "spatial_stage_infer",
    "make_spatial_infer",
    "spatial_predict",
    "pad_to_divisible",
    "spatial_divisor",
    "make_spatial_train_step",
    "make_spatial_eval_step",
]

_CL = torch.channels_last


def _n_pools(stage: int) -> int:
    return 1 if stage == 1 else stage


def _tensor_devices(mesh: Mesh) -> list[torch.device]:
    """The mesh's distinct devices as a tensor there reports its device
    (``torch.device("cpu", 1)`` holds tensors on ``cpu``)."""
    return list(dict.fromkeys(tensor_device(d) for d in mesh.distinct_devices()))


class SpatialWeights:
    """A stage's weights as the sharded forward runs them: BN folded
    (``models/folding.py``; a folded state dict passes through), every
    conv in ``dtype`` (None: float32) with its ``pack_conv`` layout and a
    float32 bias, the 1x1 heads float32; one copy on each distinct device
    of ``mesh``.  Build once and pass to ``make_spatial_infer``'s program
    in place of a state dict, so that a call does not fold and pack."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], stage: int, mesh: Mesh,
                 dtype: torch.dtype | None = None):
        sd = fold_batchnorm(state_dict)
        self.stage = stage
        self.dtype = dtype or torch.float32
        names = STAGE_BLOCKS[stage]
        self.blocks: dict[torch.device, dict] = {}
        self.heads: dict[torch.device, dict] = {}
        for dev in _tensor_devices(mesh):
            blocks = {}
            for name in names:
                if name.startswith("outc"):
                    continue
                convs = []
                for slot in (0, 3):
                    w = sd[f"{_conv_base(name)}.{slot}.weight"].to(dev, self.dtype).contiguous()
                    b = sd[f"{_conv_base(name)}.{slot}.bias"].to(dev, torch.float32).contiguous()
                    convs.append((w, b, pack_conv(w), b))
                blocks[name] = convs
            self.blocks[dev] = blocks
            self.heads[dev] = {
                h: (sd[f"{h}.conv.weight"].to(dev, torch.float32).flatten(1),
                    sd[f"{h}.conv.bias"].to(dev, torch.float32))
                for h in names if h.startswith("outc")}


# ---------------------------------------------------------------- the shard grid
class _Grid:
    """The (n_h, n_w) devices of the shards: H over ``axis``, W over
    ``w_axis`` (1 column without it), every other mesh axis at 0."""

    def __init__(self, mesh: Mesh, axis: str, w_axis: str | None):
        self.h_size = mesh.shape[axis]
        self.w_size = mesh.shape[w_axis] if w_axis else 1
        self.devices = [[mesh.device_at(**{axis: i, **({w_axis: j} if w_axis else {})})
                         for j in range(self.w_size)] for i in range(self.h_size)]


def _map(fn, *grids):
    """``fn`` over the shards of one or more grids of parts, position by position."""
    return [[fn(*parts) for parts in zip(*rows)] for rows in zip(*grids)]


def _with_halo(parts, dim: int, zero_edges: bool):
    """Every part extended by its neighbours' adjacent slice along ``dim``
    (2: the shards above and below, 3: left and right).  At the grid's
    edge: a zero slice with ``zero_edges`` (the resize bands' layout), else
    nothing (a conv pads there itself)."""
    n_h, n_w = len(parts), len(parts[0])
    out = []
    for i in range(n_h):
        row = []
        for j in range(n_w):
            x = parts[i][j]
            if dim == 2:
                prev = parts[i - 1][j] if i > 0 else None
                nxt = parts[i + 1][j] if i < n_h - 1 else None
            else:
                prev = parts[i][j - 1] if j > 0 else None
                nxt = parts[i][j + 1] if j < n_w - 1 else None
            edge = [1 if d == dim else s for d, s in enumerate(x.shape)]
            pieces = [x]
            if prev is not None:
                pieces.insert(0, prev.narrow(dim, prev.shape[dim] - 1, 1).to(x.device,
                                                                             non_blocking=True))
            elif zero_edges:
                pieces.insert(0, x.new_zeros(edge))
            if nxt is not None:
                pieces.append(nxt.narrow(dim, 0, 1).to(x.device, non_blocking=True))
            elif zero_edges:
                pieces.append(x.new_zeros(edge))
            row.append(torch.cat(pieces, dim) if len(pieces) > 1 else x)
        out.append(row)
    return out


def _conv(parts, convs):
    """One 3x3 conv + bias + ReLU across shard boundaries: H halos, then W
    halos of the H-extended blocks (the corners), one ``conv3x3`` launch per
    shard with the kernel's zero padding, the halo cropped."""
    ext = _with_halo(parts, 2, zero_edges=False)
    if len(parts[0]) > 1:
        ext = _with_halo(ext, 3, zero_edges=False)
    out = []
    for i, (row, ext_row) in enumerate(zip(parts, ext)):
        out_row = []
        for j, (x, xe) in enumerate(zip(row, ext_row)):
            w, b, pw, pb = convs[x.device]
            y = library.conv3x3(xe.contiguous(memory_format=_CL), w, b, pw, pb)
            top, left = int(i > 0), int(j > 0)
            out_row.append(y[:, :, top:top + x.shape[2], left:left + x.shape[3]])
        out.append(out_row)
    return out


@functools.lru_cache(maxsize=None)
def _axis_resize_bands(n_in: int, n_out: int, shards: int) -> np.ndarray:
    """Per-shard halo-padded resize bands for one axis, tap-checked: shape
    (shards, n_out/shards, n_in/shards + 2), band i the slab of the global
    align_corners=True matrix that shard i applies to its halo-extended
    extent.  Only the bands are kept, never the dense matrix, so each
    device's constant shrinks as the grid grows.  Raises if any output's
    taps leave the 1-px halo."""
    if n_in % shards or n_out % shards:
        raise ValueError(f"axis {n_in}->{n_out} not divisible by {shards} shards")
    w = _bilinear_ac_matrix(n_in, n_out)  # (n_out, n_in)
    wp = np.zeros((n_out, n_in + 2), dtype=np.float32)
    wp[:, 1:n_in + 1] = w
    lo, lo_out = n_in // shards, n_out // shards
    bands = []
    for i in range(shards):
        block = wp[i * lo_out:(i + 1) * lo_out]
        cols = np.nonzero(np.abs(block).sum(axis=0) > 0)[0]
        if cols.size and (cols.min() < i * lo or cols.max() >= i * lo + lo + 2):
            raise ValueError(f"resize {n_in}->{n_out}: shard {i} taps outside 1-px halo")
        bands.append(block[:, i * lo:i * lo + lo + 2])
    return np.stack(bands)


@functools.lru_cache(maxsize=256)
def _band(n_in: int, n_out: int, shards: int, i: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under the forward's inference
    # mode: the cached band serves the train steps' autograd too
    with torch.inference_mode(False):
        return torch.from_numpy(_axis_resize_bands(n_in, n_out, shards)[i]).to(device)


def _resize(parts, out_hw: tuple[int, int]):
    """Bilinear align_corners=True resize of the sharded activation to the
    GLOBAL size ``out_hw``, float32 math, result in the parts' dtype."""
    out_h, out_w = out_hw
    n_h, n_w = len(parts), len(parts[0])
    dtype = parts[0][0].dtype
    h, w = parts[0][0].shape[2:]
    y = _map(lambda t: t.float(), parts)
    if out_h != h * n_h:
        yp = _with_halo(y, 2, zero_edges=True)
        y = [[torch.einsum("ol,nclw->ncow", _band(h * n_h, out_h, n_h, i, t.device), t)
              for t in row] for i, row in enumerate(yp)]
    if out_w != w * n_w:
        if n_w > 1:
            yp = _with_halo(y, 3, zero_edges=True)
            y = [[torch.einsum("pl,nchl->nchp", _band(w * n_w, out_w, n_w, j, t.device), t)
                  for j, t in enumerate(row)] for row in yp]
        else:
            y = _map(lambda t: resize_bilinear_align_corners(t, (t.shape[2], out_w)), y)
    return _map(lambda t: t.to(dtype), y)


def _global_hw(parts) -> tuple[int, int]:
    return parts[0][0].shape[2] * len(parts), parts[0][0].shape[3] * len(parts[0])


class GridOps:
    """The blocks of ``models/pgunet.py::stage_topology`` over a grid of
    shards that split the image's H (and W): the max-pool and the concat
    shard by shard, the upsamples and the heads' resizes across the grid
    (``_resize``), the heads' sum.  A subclass gives ``dc`` and ``head``;
    ``parallel/tensor.py`` overrides ``hw`` and ``resize`` for shards that
    split the batch."""

    def pool(self, t):
        return _map(lambda p: F.max_pool2d(p, 2), t)

    def cat(self, a, b):
        return _map(lambda p, q: torch.cat([p, q], dim=1), a, b)

    def hw(self, t) -> tuple[int, int]:
        return _global_hw(t)

    def resize(self, t, hw):
        return _resize(t, hw)

    def up(self, t):
        return self.resize(t, tuple(2 * s for s in self.hw(t)))

    def heads(self, feats, names):
        hw = self.hw(feats[-1])
        out = None
        for f, name in zip(feats, names):
            o = self.head(f, name)
            o = o if self.hw(o) == hw else self.resize(o, hw)
            out = o if out is None else _map(torch.add, out, o)
        return out


class _InferOps(GridOps):
    """The eval forward on ``SpatialWeights``: BN folded, one ``conv3x3``
    launch per conv and shard, float32 heads."""

    def __init__(self, weights: SpatialWeights):
        self.weights = weights

    def dc(self, t, name):
        blocks = self.weights.blocks
        t = _conv(t, {d: b[name][0] for d, b in blocks.items()})
        return _conv(t, {d: b[name][1] for d, b in blocks.items()})

    def head(self, t, name):
        def one(p):
            k, b = self.weights.heads[p.device][name]
            return (p.float().permute(0, 2, 3, 1) @ k.t() + b).permute(0, 3, 1, 2)
        return _map(one, t)


def _stage_forward(stage: int, weights: SpatialWeights, x):
    """Eval forward of the stage on the sharded input: float32 logits per
    shard.  The topology of ``models/pgunet.py``."""
    return stage_topology(stage, _InferOps(weights), x)


# ---------------------------------------------------------------- entry points
def spatial_divisor(stage: int, mesh: Mesh, axis: str = "data",
                    w_axis: str | None = None) -> tuple[int, int]:
    """(h_div, w_div): each input axis must be a multiple of ``shards *
    2**pools`` so that per-shard extents stay even through the pool pyramid
    and the resize taps stay within 1-px halos."""
    pools = _n_pools(stage)
    return mesh.shape[axis] * 2 ** pools, (mesh.shape[w_axis] if w_axis else 1) * 2 ** pools


def pad_to_divisible(images, stage: int, mesh: Mesh, axis: str = "data",
                     w_axis: str | None = None, multiple: int | None = None):
    """Zero-pad (bottom and right) an NHWC batch, numpy or tensor, up to the
    divisibility constraint (with ``multiple``: up to multiples of its lcm
    with it, ``SlidePredictor``'s ``pad_multiple``).  Returns ``(padded,
    (orig_h, orig_w))``; crop outputs back with ``out[:, :orig_h, :orig_w]``."""
    h, w = images.shape[1], images.shape[2]
    h_div, w_div = spatial_divisor(stage, mesh, axis, w_axis)
    if multiple:
        h_div, w_div = math.lcm(h_div, int(multiple)), math.lcm(w_div, int(multiple))
    ph, pw = (-h) % h_div, (-w) % w_div
    if ph or pw:
        if isinstance(images, torch.Tensor):
            images = F.pad(images, (0, 0, 0, pw, 0, ph))
        else:
            images = np.pad(images, ((0, 0), (0, ph), (0, pw), (0, 0)))
    return images, (h, w)


def _check_divisible(stage: int, x, h_size: int, w_size: int) -> None:
    pools = _n_pools(stage)
    if x.shape[1] % (h_size * 2 ** pools) or x.shape[2] % (w_size * 2 ** pools):
        raise ValueError(
            f"(H, W)={tuple(x.shape[1:3])} not divisible by shards*2^pools "
            f"({h_size}*{2 ** pools}, {w_size}*{2 ** pools}); use pad_to_divisible")


def _gather(parts, device: torch.device) -> torch.Tensor:
    """The whole NHWC map on ``device`` from its NCHW shards."""
    rows = [torch.cat([p.to(device, non_blocking=True) for p in row], dim=3) for row in parts]
    return torch.cat(rows, dim=2).permute(0, 2, 3, 1)


def make_spatial_infer(stage: int, mesh: Mesh, axis: str = "data",
                       dtype: torch.dtype | None = None, w_axis: str | None = None):
    """A spatially sharded forward: ``(variables, x) -> logits``.

    ``x`` is the whole (N, H, W, C) float batch (numpy or a tensor on any
    device); H must divide by ``mesh.shape[axis] * 2**pools`` (pools: 1 at
    stage 1, else the stage) and, when ``w_axis`` names a second mesh axis,
    W likewise by ``mesh.shape[w_axis] * 2**pools`` (``pad_to_divisible``
    for other sizes).  ``variables``: a reference-named state dict (BN
    live or folded), folded and placed at each call, or ``SpatialWeights``
    built once for this mesh and dtype.  Returns the float32 (N, H, W, K)
    logits on the mesh's first device.  Memoised per (stage, mesh, axis,
    dtype, w_axis), as the JAX package memoises its jitted program."""
    return _make_spatial_infer(stage, mesh, axis, dtype, w_axis)


def _weights(variables, stage: int, mesh: Mesh, dtype) -> SpatialWeights:
    if not isinstance(variables, SpatialWeights):
        return SpatialWeights(variables, stage, mesh, dtype)
    if variables.stage != stage or variables.dtype != (dtype or torch.float32):
        raise ValueError(f"SpatialWeights of stage {variables.stage} in {variables.dtype} "
                         f"given to a stage-{stage} forward in {dtype or torch.float32}")
    missing = [d for d in _tensor_devices(mesh) if d not in variables.blocks]
    if missing:
        raise ValueError(f"SpatialWeights hold no copy on {missing}")
    return variables


def _split(x, grid: _Grid, dtype: torch.dtype = torch.float32):
    """A whole NHWC batch (numpy or a tensor on any device) as the grid's
    NCHW shards in ``dtype`` on their devices."""
    x = torch.as_tensor(x)
    lh, lw = x.shape[1] // grid.h_size, x.shape[2] // grid.w_size
    nchw = x.permute(0, 3, 1, 2)
    return [[nchw[:, :, i * lh:(i + 1) * lh, j * lw:(j + 1) * lw]
             .to(dev, dtype, non_blocking=True)
             for j, dev in enumerate(row)] for i, row in enumerate(grid.devices)]


class _SpatialProgram:
    """``make_spatial_infer``'s forward for one (stage, mesh, axis, dtype,
    w_axis): ``shards`` gives the float32 logits shard by shard, a call the
    gathered NHWC logits."""

    def __init__(self, stage, mesh, axis, dtype, w_axis):
        self.stage, self.mesh, self.dtype = stage, mesh, dtype
        self.grid = _Grid(mesh, axis, w_axis)

    @torch.inference_mode()
    def shards(self, variables, x):
        x = torch.as_tensor(x)
        grid = self.grid
        _check_divisible(self.stage, x, grid.h_size, grid.w_size)
        weights = _weights(variables, self.stage, self.mesh, self.dtype)
        return _stage_forward(self.stage, weights, _split(x, grid, weights.dtype))

    def __call__(self, variables, x) -> torch.Tensor:
        return _gather(self.shards(variables, x), self.mesh.first)


@functools.lru_cache(maxsize=None)
def _make_spatial_infer(stage, mesh, axis, dtype, w_axis) -> _SpatialProgram:
    return _SpatialProgram(stage, mesh, axis, dtype, w_axis)


def spatial_stage_infer(variables, x, stage: int, mesh: Mesh, axis: str = "data",
                        dtype: torch.dtype | None = None,
                        w_axis: str | None = None) -> torch.Tensor:
    """One-shot convenience wrapper over ``make_spatial_infer``."""
    return make_spatial_infer(stage, mesh, axis, dtype, w_axis)(variables, x)


def spatial_predict(variables, x, mesh: Mesh, stage: int = 4, axis: str = "data",
                    dtype: torch.dtype | None = None, w_axis: str | None = None,
                    pad: bool = False, pad_multiple: int | None = None):
    """(preds, probs, uncertainty) of a whole-slide batch, grid-sharded:
    NHWC float32 on the mesh's first device.  The tail (sigmoid, 0.5
    threshold, the uncertainty kernel on the logits) runs per shard, the
    maps then gather; binary heads only.  ``pad=True`` accepts any (H, W):
    the batch is zero-padded by ``pad_to_divisible`` (``pad_multiple``: its
    ``multiple``) and every output cropped back."""
    orig = None
    if pad:
        x, orig = pad_to_divisible(x, stage, mesh, axis, w_axis, pad_multiple)
    logits = _make_spatial_infer(stage, mesh, axis, dtype, w_axis).shards(variables, x)
    with torch.inference_mode():
        probs = _map(torch.sigmoid, logits)
        outs = [_gather(_map(lambda p: (p > 0.5).float(), probs), mesh.first),
                _gather(probs, mesh.first),
                _gather(_map(library.uncertainty_from_logits, logits), mesh.first)]
    if orig is not None:
        h, w = orig
        outs = [t[:, :h, :w] for t in outs]
    return tuple(outs)


# ---------------------------------------------------------------- training
def _conv_train(parts, conv, dtype):
    """``DoubleConv.forward_parts``'s conv over the grid: H halos, then W
    halos of the H-extended blocks, a zero-padded ``F.conv2d`` per shard,
    the halo rows and columns cropped (``_conv``'s layout)."""
    ext = _with_halo(parts, 2, zero_edges=False)
    if len(parts[0]) > 1:
        ext = _with_halo(ext, 3, zero_edges=False)
    return [[conv_part(xe, conv, dtype)[:, :, int(i > 0):int(i > 0) + x.shape[2],
                                        int(j > 0):int(j > 0) + x.shape[3]]
             for j, (x, xe) in enumerate(zip(row, ext_row))]
            for i, (row, ext_row) in enumerate(zip(parts, ext))]


class _ModelOps(GridOps):
    """The live-BN model's blocks over the grid (train or eval mode, as
    the model is); ``dtype``: their compute dtype (default the blocks')."""

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype

    def dc(self, t, name):
        return block_double_conv(self.model, name).forward_parts(t, _conv_train, self.dtype,
                                                                 check_axis=False)

    def head(self, t, name):
        return _map(self.model.get_submodule(name), t)


def _flat(parts) -> list:
    return [t for row in parts for t in row]


def _spatial_unc_map(prev_weights: SpatialWeights, x):
    """The frozen previous stage's (probabilities, uncertainty map) on the
    grid: ``x`` resized by half through the bands, the folded inference
    forward, sigmoid, resized back, ``1 - 2|P - 0.5|``; no gradient."""
    h, w = _global_hw(x)
    with torch.no_grad():
        x_prev = _map(lambda t: t.to(prev_weights.dtype), _resize(x, (h // 2, w // 2)))
        logits = _stage_forward(prev_weights.stage, prev_weights, x_prev)
        probs = _resize(_map(lambda t: torch.sigmoid(t.float()), logits), (h, w))
        return probs, _map(binary_uncertainty, probs)


def _spatial_loss_and_metrics(stage, ops, prev_weights, x, y, pos_weight, alpha, fused_loss,
                              home):
    """(the global final loss, the six global metrics) of one batch on the
    grid: per shard ``shard_loss``, the shards' means averaged."""
    probs = uncs = None
    if prev_weights is not None:
        probs, uncs = (_flat(t) for t in _spatial_unc_map(prev_weights, x))
    logits = _flat(stage_topology(stage, ops, x))
    ys = _flat(y)
    losses = [shard_loss(lg, t, None if probs is None else probs[i],
                         None if uncs is None else uncs[i], pos_weight, alpha, fused_loss)
              for i, (lg, t) in enumerate(zip(logits, ys))]
    final = sum(f.to(home) for f, _ in losses) / len(losses)
    return final, grid_metrics([f for f, _ in losses], [b for _, b in losses], logits, ys, uncs,
                               home, batch_split=False)


def _prev_weights(stage, prev_model, mesh, dtype):
    if stage == 1 or prev_model is None:
        return None
    return SpatialWeights(prev_model.state_dict(), stage - 1, mesh, dtype)


def make_spatial_train_step(model, optimizer, stage: int, mesh: Mesh, axis: str = "data",
                            w_axis: str | None = None, prev_model=None, alpha: float = 1.0,
                            dtype: torch.dtype | None = None, accum_steps: int = 1,
                            fused_loss: bool = False):
    """A native-resolution, spatially sharded train step (the JAX
    package's ``make_spatial_train_step``): ``step(batch, pos_weight) ->
    metrics``, one update of the live-BN stage ``model`` through
    ``optimizer``.  ``batch = (images (N, H, W, 3), masks (N, H, W, 1))``
    at native resolution, H and W divisible as ``spatial_divisor`` says
    (``pad_to_divisible`` otherwise); H shards over ``axis``, W over
    ``w_axis`` when given.  No resize to the stage's resolution and no
    augmentation, as in JAX.  ``prev_model`` (stage > 1): the frozen
    previous stage, the uncertainty source, its weights folded once here.
    ``dtype``: the blocks' compute dtype (default their own).
    ``accum_steps=K``: K micro-batches in order, gradients averaged, one
    update; the metrics their means.  ``fused_loss``: the loss kernels,
    one forward and one backward launch per shard."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    grid = _Grid(mesh, axis, w_axis)
    ops = _ModelOps(model, dtype)
    params = [p for p in model.parameters() if p.requires_grad]
    prev_weights = _prev_weights(stage, prev_model, mesh, dtype)

    def step(batch, pos_weight: float):
        x, y = torch.as_tensor(batch[0]), torch.as_tensor(batch[1])
        _check_divisible(stage, x, grid.h_size, grid.w_size)
        n = x.shape[0]
        if n % accum_steps:
            raise ValueError(f"batch size {n} is not divisible by accum_steps={accum_steps}")
        m = n // accum_steps
        home = params[0].device
        optimizer.zero_grad(set_to_none=True)
        model.train()
        parts = []
        for i in range(accum_steps):
            final, metrics = _spatial_loss_and_metrics(
                stage, ops, prev_weights, _split(x[i * m:(i + 1) * m], grid),
                _split(y[i * m:(i + 1) * m], grid), pos_weight, alpha, fused_loss, home)
            final.backward()
            parts.append(metrics)
        if accum_steps > 1:
            for p in params:  # the micro-batches' gradients were summed
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        distributed.average_gradients(params)  # over processes: each has its own images
        optimizer.step()
        if accum_steps == 1:
            return parts[0]
        return {k: torch.stack([part[k] for part in parts]).mean() for k in parts[0]}

    return step


def make_spatial_eval_step(model, stage: int, mesh: Mesh, axis: str = "data",
                           w_axis: str | None = None, prev_model=None, alpha: float = 1.0,
                           dtype: torch.dtype | None = None):
    """The native-resolution validation step (eval-mode BN, the plain
    loss, no update): ``step(batch, pos_weight) -> metrics``, the train
    step's metrics."""
    grid = _Grid(mesh, axis, w_axis)
    ops = _ModelOps(model, dtype)
    prev_weights = _prev_weights(stage, prev_model, mesh, dtype)

    @torch.no_grad()
    def step(batch, pos_weight: float):
        x, y = torch.as_tensor(batch[0]), torch.as_tensor(batch[1])
        _check_divisible(stage, x, grid.h_size, grid.w_size)
        model.eval()
        return _spatial_loss_and_metrics(stage, ops, prev_weights, _split(x, grid),
                                         _split(y, grid), pos_weight, alpha, False,
                                         next(model.parameters()).device)[1]

    return step
