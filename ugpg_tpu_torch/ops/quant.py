"""Post-training W8A8 int8 quantization of the PGUNet stages and of the Herlev
classifier's encoder (counterpart of ``ugpg_tpu/ops/quant.py``).

The scheme is the JAX package's:

* BatchNorm is folded first (``models/folding.py``), so every conv is a
  conv with a bias.  The functions here read the port's folded,
  reference-named state dict (``inc.conv.conv_op.{0,3}``,
  ``downX.mpconv.1.conv_op.N``, ``upX.conv.conv_op.N``, ``outcX.conv``;
  ``unet.``-prefixed and ``classifier.{3,6,9}`` for the classifier).
* Weights: per-output-channel symmetric int8 of ``W[:, :, c, o] * s_in[c]``:
  the consumer's per-input-channel activation scale is baked into ``wq``,
  so the two halves of an Up block's concat (the skip at its producer's
  scale, the upsampled half at its own) feed conv1 without a requantize.
* Activations: per-tensor symmetric int8 at every quantization point
  (``in``, ``{block}.mid``, ``{block}.out``, ``{up}.up``), the scale
  ``max|x| / 127`` over calibration batches, taken by the folded float
  walker (``float_folded_forward``, bf16 by default).
* Each conv's epilogue: per-channel scale, bias, ReLU, and a requantize at
  the next point's scale.  Max-pool runs on int8.  An Up block's 2x
  upsample interpolates the dequantized bf16 half and requantizes it at its
  own scale; the heads read bf16 features and sum in float32.  The
  classifier's GAP and MLP head stay float32.

Where the port computes otherwise than XLA, it follows what the JAX
package's jitted program (``QuantizedModel``, the scales closed over as
constants) computes on the CPU:

* The int8 conv is ``torch._int_mm`` (int8 x int8 -> int32, exact) on a
  3x3 patch matrix: the NHWC input padded by one pixel, its 9 tap-shifted
  views concatenated in (ky, kx, c_in) order, the order of the HWIO
  weights' reshape.  C_in is padded with zero channels to a multiple of 8
  (cuBLASLt's rule for K; the sums stay exact), and the batch is split so
  that a patch matrix stays under ``_PATCH_BYTES``.  ``F.conv2d`` on int8
  wraps each sum mod 256 on the CPU, ``F.unfold`` has no int8 kernel
  there, and float32 sums are not exact above 2^24.
* XLA contracts the epilogue's ``y * scale + bias`` into a fused
  multiply-add.  The port computes it in float64, where the product is
  exact, and rounds to float32: the fused result but for a double rounding
  (about one value in 2^29), and the same on either device.
* XLA folds the requantize's division by a constant scale into a multiply
  by the float32 reciprocal; the port multiplies by that reciprocal, held
  as a float32 tensor.  ``quantize_weights`` runs eagerly in JAX, so its
  divisions are true divisions here too, on the CPU.
* The upsample is the operator ``torch.ops.ugpg_torch.upsample2x_bf16_taps``
  (the hand-written kernel's bf16 instance on the GPU), which rounds as
  JAX's bf16 resize does: the tap weights rounded to bf16, each pass summed
  in float32, the H pass rounded to bf16 before the W pass.  So every int8
  point equals JAX's (``tests/test_torch_quant.py``).

``QuantizedModel`` and ``QuantizedClassifier`` are ``nn.Module``s (NCHW in,
as the port's models; the weights and scales as buffers), so that
``Predictor.export`` traces them; ``quantized_forward`` and
``quantized_cls_forward`` are the JAX package's functional forms (NHWC in).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.models.classifier import ENCODER_SPECS
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    upsample2x_bilinear_align_corners,
)

__all__ = [
    "quantize_weights",
    "calibrate",
    "quantized_forward",
    "float_folded_forward",
    "quantize_cls_weights",
    "calibrate_cls",
    "quantized_cls_forward",
    "float_folded_cls_forward",
    "QuantizedModel",
    "QuantizedClassifier",
    "weight_matrix",
]

# Per-stage topology (a copy of the JAX package's ``_TOPOLOGY``): encoder
# block names in order (every block after the first is preceded by a 2x2
# max-pool), the number of Up blocks, the head names.  Up block i takes
# encoder output enc[-2 - i] as its skip.
_TOPOLOGY = {
    1: (("inc", "down4"), 1, ("outc",)),
    2: (("inc", "down3", "down4"), 2, ("outc1", "outc2")),
    3: (("inc", "down2", "down3", "down4"), 3, ("outc1", "outc2", "outc3")),
    4: (("inc", "down1", "down2", "down3", "down4"), 4, ("outc1", "outc2", "outc3", "outc4")),
}
_PATCH_BYTES = 1 << 30  # the largest int8 patch matrix one _int_mm call reads
_K_MULTIPLE = 8  # cuBLASLt's int8 GEMM wants K and N multiples of 8
_CLS_PREFIX = "unet."
_CLS_HEAD = {"fc1": "classifier.3", "fc2": "classifier.6", "fc3": "classifier.9"}


def _conv_base(name: str, prefix: str = "") -> str:
    return f"{prefix}{name}.{'mpconv.1' if name.startswith('down') else 'conv'}.conv_op"


def _block_params(sd: Mapping, name: str, prefix: str = "") -> tuple[dict, dict]:
    """(conv1, conv2) of a DoubleConv block: HWIO float32 kernels and biases."""
    base = _conv_base(name, prefix)
    return tuple({"kernel": sd[f"{base}.{slot}.weight"].float().permute(2, 3, 1, 0),
                  "bias": sd[f"{base}.{slot}.bias"].float()} for slot in (0, 3))


def _cls_block_names(stage: int) -> list[str]:
    return ["inc"] + [name for name, _ in ENCODER_SPECS[stage][1]]


def _on_cpu(state_dict: Mapping) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu().float() for k, v in state_dict.items()}


# ---------------------------------------------------------------- weight quantization
def _quant_conv(conv: Mapping[str, torch.Tensor], s_in) -> dict:
    """int8-quantize one HWIO kernel with its input scale(s) baked in:
    ``s_in`` a float or an (in_channels,) vector, ``W_eff = W * s_in[c]``.
    Float32 on the CPU, true divisions, as JAX's eager call computes it."""
    k = conv["kernel"].float()
    s_in = torch.from_numpy(np.asarray(s_in, np.float32))
    k = k * (s_in[None, None, :, None] if s_in.dim() == 1 else s_in)
    scale = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
    wq = torch.round(k / scale).clamp(-127, 127).to(torch.int8)
    return {"wq": wq, "scale": scale, "bias": conv["bias"].float()}


def _quant_chain(sd: Mapping, names, scales: Mapping[str, float], prefix: str = "") -> dict:
    """Quantize a chain of blocks, each fed by the previous one's output."""
    out, s_prev = {}, scales["in"]
    for name in names:
        c1, c2 = _block_params(sd, name, prefix)
        out[name] = {"conv1": _quant_conv(c1, s_prev),
                     "conv2": _quant_conv(c2, scales[f"{name}.mid"])}
        s_prev = scales[f"{name}.out"]
    return out


def quantize_weights(state_dict: Mapping[str, torch.Tensor], stage: int,
                     scales: Mapping[str, float]) -> dict:
    """Per-output-channel symmetric int8 of every DoubleConv kernel of a
    folded segmentation state dict, each conv's input scale(s) baked in.
    The 1x1 heads stay float32.  Returns ``{block: {convN: {"wq": int8
    (3, 3, in, out), "scale": (out,), "bias": (out,)}}, "__heads__": {head:
    {"kernel": (1, 1, C, K), "bias": (K,)}}}`` on the CPU."""
    sd = _on_cpu(state_dict)
    enc, n_ups, heads = _TOPOLOGY[stage]
    out = _quant_chain(sd, enc, scales)
    for i in range(n_ups):
        name = f"up{i + 1}"
        skip = enc[len(enc) - 2 - i]
        c1, c2 = _block_params(sd, name)
        c_skip = _block_params(sd, skip)[1]["kernel"].shape[-1]
        c_total = c1["kernel"].shape[-2]
        # the concat [skip at its producer's scale | upsampled at its own]
        s_in = np.concatenate([np.full(c_skip, scales[f"{skip}.out"], np.float32),
                               np.full(c_total - c_skip, scales[f"{name}.up"], np.float32)])
        out[name] = {"conv1": _quant_conv(c1, s_in),
                     "conv2": _quant_conv(c2, scales[f"{name}.mid"])}
    out["__heads__"] = {h: {"kernel": sd[f"{h}.conv.weight"].permute(2, 3, 1, 0).contiguous(),
                            "bias": sd[f"{h}.conv.bias"]} for h in heads}
    return out


def quantize_cls_weights(state_dict: Mapping[str, torch.Tensor], stage: int,
                         scales: Mapping[str, float]) -> dict:
    """int8-quantize the folded classifier's encoder convs (input scales
    baked in); the MLP head stays float32, its kernels (in, out) as JAX's."""
    sd = _on_cpu(state_dict)
    out = _quant_chain(sd, _cls_block_names(stage), scales, _CLS_PREFIX)
    out["__head__"] = {fc: {"kernel": sd[f"{slot}.weight"].t().contiguous(),
                            "bias": sd[f"{slot}.bias"]} for fc, slot in _CLS_HEAD.items()}
    return out


# ---------------------------------------------------------------- the float walker
def _fblock(x: torch.Tensor, sd: Mapping, name: str, prefix: str, dtype: torch.dtype):
    """Folded DoubleConv in ``dtype`` (bias added in ``dtype``, as JAX's
    walker); NCHW.  Returns (middle activation, output)."""
    base = _conv_base(name, prefix)

    def conv(t, slot):
        y = F.conv2d(t, sd[f"{base}.{slot}.weight"].to(dtype), padding=1)
        return torch.relu(y + sd[f"{base}.{slot}.bias"].to(dtype)[:, None, None])

    mid = conv(x, 0)
    return mid, conv(mid, 3)


def _heads_sum(feats, heads, head_params: Mapping, res: int) -> torch.Tensor:
    """Float32 sum of the 1x1 heads on NHWC ``feats``, each resized to
    ``res``: NCHW (N, K, res, res).  bf16 features (the int8 path) meet
    bf16-rounded kernels with float32 sums, as JAX's bf16 contraction with
    float32 accumulation; float features meet float32 kernels."""
    total = None
    for h, x in zip(heads, feats):
        k = head_params[h]["kernel"][0, 0]  # (C, K)
        if x.dtype == torch.bfloat16:
            k = k.to(torch.bfloat16)
        o = (x.float() @ k.float() + head_params[h]["bias"].float()).permute(0, 3, 1, 2)
        o = resize_bilinear_align_corners(o, (res, res))
        total = o if total is None else total + o
    return total


def float_folded_forward(state_dict: Mapping[str, torch.Tensor], stage: int, x: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16):
    """Folded float forward through the walker; ``x`` NHWC float32 on the
    state dict's device.  Returns ``(logits (N, H, W, K), amax)``, ``amax``
    mapping every quantization point to max|x| over this batch (0-d
    float32 tensors)."""
    enc, n_ups, heads = _TOPOLOGY[stage]
    amax = {"in": x.abs().amax().float()}
    cur = x.permute(0, 3, 1, 2).to(dtype)
    enc_out = []
    for i, name in enumerate(enc):
        if i > 0:
            cur = F.max_pool2d(cur, 2)
        mid, cur = _fblock(cur, state_dict, name, "", dtype)
        amax[f"{name}.mid"] = mid.amax().float()
        amax[f"{name}.out"] = cur.amax().float()
        enc_out.append(cur)
    dec_out = []
    for i in range(n_ups):
        name = f"up{i + 1}"
        up = upsample2x_bilinear_align_corners(cur)
        amax[f"{name}.up"] = up.abs().amax().float()
        mid, cur = _fblock(torch.cat([enc_out[len(enc) - 2 - i], up], dim=1), state_dict, name,
                           "", dtype)
        amax[f"{name}.mid"] = mid.amax().float()
        amax[f"{name}.out"] = cur.amax().float()
        dec_out.append(cur)
    head_params = {h: {"kernel": state_dict[f"{h}.conv.weight"].permute(2, 3, 1, 0),
                       "bias": state_dict[f"{h}.conv.bias"]} for h in heads}
    feats = [t.permute(0, 2, 3, 1) for t in dec_out]
    logits = _heads_sum(feats, heads, head_params, dec_out[-1].shape[-1])
    return logits.permute(0, 2, 3, 1), amax


def _mlp_head(head: Mapping, h: torch.Tensor) -> torch.Tensor:
    h = torch.relu(h @ head["fc1"]["kernel"] + head["fc1"]["bias"])
    h = torch.relu(h @ head["fc2"]["kernel"] + head["fc2"]["bias"])
    return h @ head["fc3"]["kernel"] + head["fc3"]["bias"]


def float_folded_cls_forward(state_dict: Mapping[str, torch.Tensor], stage: int,
                             x: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """Folded float classifier forward, ``x`` NHWC; returns (logits (N, K),
    amax)."""
    amax = {"in": x.abs().amax().float()}
    cur = x.permute(0, 3, 1, 2).to(dtype)
    for i, name in enumerate(_cls_block_names(stage)):
        if i > 0:
            cur = F.max_pool2d(cur, 2)
        mid, cur = _fblock(cur, state_dict, name, _CLS_PREFIX, dtype)
        amax[f"{name}.mid"] = mid.amax().float()
        amax[f"{name}.out"] = cur.amax().float()
    head = {fc: {"kernel": state_dict[f"{slot}.weight"].float().t(),
                 "bias": state_dict[f"{slot}.bias"].float()} for fc, slot in _CLS_HEAD.items()}
    return _mlp_head(head, cur.float().mean(dim=(2, 3))), amax


@torch.no_grad()
def _calibrate(walker, state_dict, stage, batches, dtype, device) -> dict[str, float]:
    device = resolve_device(device)
    sd = {k: v.detach().to(device) for k, v in state_dict.items()}
    running: dict[str, float] = {}
    for batch in batches:
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(device)
        _, amax = walker(sd, stage, x, dtype)
        for k, v in amax.items():
            running[k] = max(running.get(k, 0.0), v.item())
    return {k: max(v, 1e-12) / 127.0 for k, v in running.items()}


def calibrate(state_dict: Mapping[str, torch.Tensor], stage: int,
              batches: Iterable[np.ndarray], dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device | None = None) -> dict[str, float]:
    """Run the folded walker over calibration batches (NHWC float images) on
    ``device`` (``cuda`` unless given); return each point's activation scale,
    ``max(amax, 1e-12) / 127`` as a Python float."""
    return _calibrate(float_folded_forward, state_dict, stage, batches, dtype, device)


def calibrate_cls(state_dict: Mapping[str, torch.Tensor], stage: int,
                  batches: Iterable[np.ndarray], dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device | None = None) -> dict[str, float]:
    """``calibrate`` for the classifier's encoder."""
    return _calibrate(float_folded_cls_forward, state_dict, stage, batches, dtype, device)


# ---------------------------------------------------------------- the int8 path
def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (3, 3, C_in, C_out) -> the (9 * C_pad, C_out) int8 matrix
    ``_conv_i8`` multiplies, rows in (ky, kx, c_in) order, C_in padded with
    zero channels to a multiple of 8."""
    c_in = wq.shape[2]
    pad = -c_in % _K_MULTIPLE
    if pad:
        wq = F.pad(wq, (0, 0, 0, pad))
    return wq.reshape(-1, wq.shape[-1]).contiguous()


def _conv_i8(xq: torch.Tensor, w: torch.Tensor, epilogue=None) -> torch.Tensor:
    """3x3 'same' conv of NHWC int8 ``xq`` with ``weight_matrix`` ``w``:
    exact int32 sums (B, H, W, C_out), or ``epilogue`` of them, applied per
    chunk of images.  ``torch._int_mm`` on the 9-tap patch matrix; the batch
    runs in chunks whose patch matrix stays under ``_PATCH_BYTES``."""
    n, h, wd, c = xq.shape
    c_pad = w.shape[0] // 9
    step = max(1, _PATCH_BYTES // (h * wd * 9 * c_pad))
    outs = []
    for s in range(0, n, step):
        xp = F.pad(xq[s:s + step], (0, c_pad - c, 1, 1, 1, 1))  # zero channels, a zero border
        patches = torch.cat([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)],
                            dim=-1)
        acc = torch._int_mm(patches.reshape(-1, 9 * c_pad), w)
        out = acc if epilogue is None else epilogue(acc)
        outs.append(out.reshape(-1, h, wd, out.shape[-1]))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _recip(scale: float) -> torch.Tensor:
    """The float32 reciprocal XLA multiplies by for ``x / scale``."""
    return torch.tensor(np.float32(1.0) / np.float32(scale))


def _requant(f: torch.Tensor, recip: torch.Tensor) -> torch.Tensor:
    """round-half-even(f * recip), clipped to [-127, 127], as int8."""
    return torch.round(f * recip).clamp_(-127, 127).to(torch.int8)


def _epilogue(acc, scale, bias, recip):
    """int32 sums -> float32 -> scale * y + bias, fused (float64, exact
    product), ReLU, requantized at the next point's scale."""
    f = torch.addcmul(bias, acc.float().double(), scale).float().relu_()
    return _requant(f, recip)


def _pool(q: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC int8 (the scale is unchanged)."""
    n, h, w, c = q.shape
    return q.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class _QConv(nn.Module):
    """One int8 3x3 conv with its epilogue, requantized at ``s_out``."""

    def __init__(self, qconv: Mapping[str, torch.Tensor], s_out: float):
        super().__init__()
        self.register_buffer("w", weight_matrix(qconv["wq"]))
        self.register_buffer("scale", qconv["scale"].double())
        self.register_buffer("bias", qconv["bias"].double())
        self.register_buffer("recip", _recip(s_out))

    def forward(self, xq: torch.Tensor) -> torch.Tensor:
        return _conv_i8(xq, self.w, lambda acc: _epilogue(acc, self.scale, self.bias,
                                                          self.recip))


class _QBlock(nn.Module):
    """int8 DoubleConv; ``s_bf16``/``s_f32``: its output scale for the
    dequantizations downstream; ``up_recip``: an Up block's upsample scale."""

    def __init__(self, qblock: Mapping, scales: Mapping[str, float], name: str):
        super().__init__()
        self.name = name
        self.conv1 = _QConv(qblock["conv1"], scales[f"{name}.mid"])
        self.conv2 = _QConv(qblock["conv2"], scales[f"{name}.out"])
        s_out = torch.tensor(scales[f"{name}.out"], dtype=torch.float64)
        self.register_buffer("s_bf16", s_out.to(torch.bfloat16))
        self.register_buffer("s_f32", s_out.float())
        if f"{name}.up" in scales:
            self.register_buffer("up_recip", _recip(scales[f"{name}.up"]))

    def forward(self, xq: torch.Tensor, points: dict | None = None) -> torch.Tensor:
        mid = self.conv1(xq)
        out = self.conv2(mid)
        if points is not None:
            points[f"{self.name}.mid"], points[f"{self.name}.out"] = mid, out
        return out


class _Int8Net(nn.Module):
    """An int8 encoder walk; subclasses give the calibration, the weight
    quantization and ``forward_nhwc``."""

    _calibrate = _quantize = None

    def __init__(self, qparams: Mapping, scales: Mapping[str, float], stage: int, names):
        super().__init__()
        self.stage = stage
        self.scales = dict(scales)
        self.register_buffer("in_recip", _recip(scales["in"]))
        self.blocks = nn.ModuleDict({n: _QBlock(qparams[n], scales, n) for n in names})

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, torch.Tensor], stage: int,
                        calibration_batches: Iterable[np.ndarray],
                        device: str | torch.device | None = None):
        """BN folding, bf16 calibration on ``device`` (``cuda`` unless given)
        and weight quantization of a reference state dict (for the
        classifier, its encoder and head: ``io/checkpoint.py::
        classifier_state_dict``); the model on ``device`` in eval mode."""
        device = resolve_device(device)
        folded = fold_batchnorm(state_dict)
        scales = cls._calibrate(folded, stage, calibration_batches, device=device)
        return cls(cls._quantize(folded, stage, scales), scales, stage).to(device).eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW float32 images (a view of NHWC memory, as ``Predictor`` passes
        them) -> ``forward_nhwc``'s logits."""
        return self.forward_nhwc(x.permute(0, 2, 3, 1))

    def _encode(self, x: torch.Tensor, names, points: dict | None) -> list[torch.Tensor]:
        """NHWC float32 -> the int8 output of each encoder block."""
        cur, outs = _requant(x.float(), self.in_recip), []
        if points is not None:
            points["in"] = cur
        for i, name in enumerate(names):
            if i > 0:
                cur = _pool(cur)
            cur = self.blocks[name](cur, points)
            outs.append(cur)
        return outs


class QuantizedModel(_Int8Net):
    """Calibrated W8A8 PGUNet stage: NCHW float32 images -> NCHW float32
    logits (N, K, H, W).  Build with ``QuantizedModel.from_state_dict``."""

    _calibrate, _quantize = staticmethod(calibrate), staticmethod(quantize_weights)

    def __init__(self, qparams: Mapping, scales: Mapping[str, float], stage: int):
        enc, n_ups, heads = _TOPOLOGY[stage]
        ups = tuple(f"up{i + 1}" for i in range(n_ups))
        super().__init__(qparams, scales, stage, enc + ups)
        self.enc, self.ups, self.heads = enc, ups, heads
        for h in heads:
            self.register_buffer(f"{h}_kernel", qparams["__heads__"][h]["kernel"].float())
            self.register_buffer(f"{h}_bias", qparams["__heads__"][h]["bias"].float())

    def forward_nhwc(self, x: torch.Tensor, points: dict | None = None) -> torch.Tensor:
        """NHWC float32 -> NCHW logits; ``points``, if given, receives the
        int8 tensor of every quantization point by name."""
        enc_out = self._encode(x, self.enc, points)
        cur, prev, dec_out = enc_out[-1], self.blocks[self.enc[-1]], []
        for i, name in enumerate(self.ups):
            block = self.blocks[name]
            deq = cur.to(torch.bfloat16) * prev.s_bf16
            up = library.upsample2x_bf16_taps(deq.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            up_q = _requant(up.float(), block.up_recip)
            if points is not None:
                points[f"{name}.up"] = up_q
            cur = block(torch.cat([enc_out[len(self.enc) - 2 - i], up_q], dim=-1), points)
            prev = block
            dec_out.append(cur.to(torch.bfloat16) * block.s_bf16)
        head_params = {h: {"kernel": getattr(self, f"{h}_kernel"),
                           "bias": getattr(self, f"{h}_bias")} for h in self.heads}
        return _heads_sum(dec_out, self.heads, head_params, cur.shape[1])


class QuantizedClassifier(_Int8Net):
    """Calibrated W8A8 Herlev classifier: an int8 encoder, float32 GAP
    times the last scale, the float32 MLP head.  NCHW images -> logits
    (N, K).  Build with ``QuantizedClassifier.from_state_dict``."""

    _calibrate, _quantize = staticmethod(calibrate_cls), staticmethod(quantize_cls_weights)

    def __init__(self, qparams: Mapping, scales: Mapping[str, float], stage: int):
        names = tuple(_cls_block_names(stage))
        super().__init__(qparams, scales, stage, names)
        self.names = names
        for fc in _CLS_HEAD:
            self.register_buffer(f"{fc}_kernel", qparams["__head__"][fc]["kernel"].float())
            self.register_buffer(f"{fc}_bias", qparams["__head__"][fc]["bias"].float())

    def forward_nhwc(self, x: torch.Tensor, points: dict | None = None) -> torch.Tensor:
        """NHWC float32 -> logits (N, K); ``points`` as ``QuantizedModel``'s."""
        cur = self._encode(x, self.names, points)[-1]
        h = cur.float().mean(dim=(1, 2)) * self.blocks[self.names[-1]].s_f32
        head = {fc: {"kernel": getattr(self, f"{fc}_kernel"),
                     "bias": getattr(self, f"{fc}_bias")} for fc in _CLS_HEAD}
        return _mlp_head(head, h)


@torch.no_grad()
def quantized_forward(qparams: Mapping, scales: Mapping[str, float], stage: int,
                      x: torch.Tensor, points: dict | None = None) -> torch.Tensor:
    """W8A8 int8 forward of NHWC float32 ``x`` (on its device) -> NHWC
    logits (N, H, W, K); ``points`` as ``QuantizedModel.forward_nhwc``'s."""
    model = QuantizedModel(qparams, scales, stage).to(x.device)
    return model.forward_nhwc(x, points).permute(0, 2, 3, 1)


@torch.no_grad()
def quantized_cls_forward(qparams: Mapping, scales: Mapping[str, float], stage: int,
                          x: torch.Tensor, points: dict | None = None) -> torch.Tensor:
    """W8A8 int8 classifier forward of NHWC ``x`` -> logits (N, K)."""
    return QuantizedClassifier(qparams, scales, stage).to(x.device).forward_nhwc(x, points)
