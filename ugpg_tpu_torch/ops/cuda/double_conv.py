"""DoubleConv on BN-folded weights: (3x3 conv + bias + ReLU) x 2.

Counterpart of ``ugpg_tpu/ops/pallas/double_conv.py::fused_double_conv``.
``fused_double_conv`` launches the CUDA kernels (``csrc/double_conv.cu``)
for CUDA tensors and takes the plain version,
``fused_double_conv_reference``, only for CPU tensors.  bfloat16 runs the
tensor-core conv twice (conv1 into a bf16 scratch tensor, then conv2);
float32 runs the CUDA-core conv (an implicit GEMM in float32 FMA, which
matches the CPU to 1e-4) twice the same way, into a float32 middle tensor.
``f32_plan`` picks each float32 launch's output channels per block.

Tensors follow PyTorch's conventions: ``x`` is (N, Cin, H, W), stored
``torch.channels_last`` on the GPU (NHWC memory, as the kernels read it);
weights are ``nn.Conv2d``'s (Cout, Cin, 3, 3).  The middle activation is
rounded to ``x.dtype``; sums are float32.  Any H and W are accepted: the
kernels mask the ragged edge (the JAX kernel's ``tile_h`` divisibility
rule was a TPU constraint).

The kernels take their weights in their own layouts (``pack_double_conv``);
``DoubleConv.pack`` keeps them on the module so that a call does not
repack, and calls without them pack on the fly.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ugpg_tpu_torch.ops.cuda import _lib

__all__ = [
    "F32_TILE",
    "F32_MIN_BLOCKS",
    "conv_chunk",
    "f32_blocks",
    "f32_launches",
    "f32_plan",
    "pack_conv3x3",
    "pack_double_conv",
    "conv3x3_packed_reference",
    "fused_double_conv",
    "fused_double_conv_reference",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 7 + (_I,) * 8 + (_P,)

F32_TILE = (8, 16)  # the float32 conv's output tile: rows, columns
F32_MIN_BLOCKS = 256  # about two blocks per SM on the H100's 132


def f32_blocks(n: int, h: int, w: int, cout: int, bn: int) -> int:
    """Blocks of one float32 conv launch: (pixel tiles, Cout / bn, N)."""
    th, tw = F32_TILE
    return -(-h // th) * -(-w // tw) * -(-cout // bn) * n


def f32_plan(n: int, h: int, w: int, cout: int) -> int:
    """Output channels per block (BN) of one float32 conv: 64, or 32 when
    ``cout`` <= 32 or when 64 would leave the grid under
    ``F32_MIN_BLOCKS`` blocks (32 doubles it where ``cout`` > 32)."""
    if cout > 32 and f32_blocks(n, h, w, cout, 64) >= F32_MIN_BLOCKS:
        return 64
    return 32


def conv_chunk(cin: int) -> int:
    """Input channels the tensor-core conv stages per step (its K chunk):
    16 when ``cin`` <= 16, else 32."""
    return 16 if cin <= 16 else 32


def _padded(cin: int) -> int:
    """``cin`` rounded up to a multiple of ``conv_chunk(cin)``."""
    kc = conv_chunk(cin)
    return -(-cin // kc) * kc


def f32_launches() -> int:
    """Launches of the float32 conv kernel in this process so far, modulo
    2^31: the C side's own count, two per float32 ``fused_double_conv``."""
    return _lib.function("double_conv", "ugpg_conv3x3_f32_launches", ())()


def pack_conv3x3(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (9, Cout, Cpad) tap-major (tap = 3*dy + dx),
    input channels innermost and zero-padded to a multiple of
    ``conv_chunk(Cin)``: the tensor-core conv's weight layout."""
    cout, cin = w.shape[:2]
    taps = w.permute(2, 3, 0, 1).reshape(9, cout, cin)
    return F.pad(taps, (0, _padded(cin) - cin)).contiguous()


def pack_double_conv(w1, b1, w2, b2) -> tuple[torch.Tensor, ...]:
    """The kernels' layouts of a DoubleConv's weights, by their dtype:
    bfloat16 ``pack_conv3x3`` each, float32 (3, 3, Cin, Cout); biases
    float32.  Returns (w1, b1, w2, b2)."""
    if w1.dtype == torch.bfloat16:
        w1k, w2k = pack_conv3x3(w1), pack_conv3x3(w2)
    else:
        w1k, w2k = (w.permute(2, 3, 1, 0).contiguous() for w in (w1, w2))
    return w1k, b1.float().contiguous(), w2k, b2.float().contiguous()


def conv3x3_packed_reference(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of one tensor-core conv: conv3x3 (zero pad) + bias +
    ReLU from ``pack_conv3x3`` weights, summed in float32 the way the
    kernel walks K: chunks of ``conv_chunk(Cin)`` input channels (x
    zero-padded to the packed width), and within each chunk the 9 taps.
    Returns float32 (N, Cout, H, W)."""
    n, cin, h, w = x.shape
    _, cout, cpad = wp.shape
    kc = conv_chunk(cin)
    if cpad != _padded(cin):
        raise ValueError(f"packed weights {tuple(wp.shape)} do not fit {cin} input channels")
    xp = F.pad(x.float(), (1, 1, 1, 1, 0, cpad - cin))
    acc = torch.zeros(n, cout, h, w, dtype=torch.float32, device=x.device)
    for c0 in range(0, cpad, kc):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc += torch.einsum("nchw,oc->nohw", xp[:, c0:c0 + kc, dy:dy + h, dx:dx + w],
                                wp[tap, :, c0:c0 + kc].float())
    return F.relu(acc + b.float()[:, None, None])


def fused_double_conv_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` twice in float32 with ReLU, the
    middle activation rounded to ``x.dtype``; result in ``x.dtype``."""
    mid = F.relu(F.conv2d(x.float(), w1.float(), b1.float(), padding=1)).to(x.dtype)
    out = F.relu(F.conv2d(mid.float(), w2.float(), b2.float(), padding=1))
    return out.to(x.dtype)


def fused_double_conv(x, w1, b1, w2, b2, packed=None) -> torch.Tensor:
    """(N, Cin, H, W) -> (N, Cout, H, W) in ``x.dtype`` (float32 or
    bfloat16); ``w1``/``w2`` in ``x.dtype``, any bias dtype.  ``packed``:
    ``pack_double_conv(w1, b1, w2, b2)`` made ahead, or None to pack here."""
    if x.device.type == "cpu":
        return fused_double_conv_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv: unsupported device {x.device}")
    _lib.dtype_code(x, "fused_double_conv")
    n, cin, h, w = x.shape
    cm, cout = w1.shape[0], w2.shape[0]
    if tuple(w1.shape) != (cm, cin, 3, 3) or tuple(w2.shape) != (cout, cm, 3, 3):
        raise ValueError(f"fused_double_conv: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not chain from {cin} input channels")
    if tuple(b1.shape) != (cm,) or tuple(b2.shape) != (cout,):
        raise ValueError("fused_double_conv: one bias value per output channel expected")
    if cm % 8 or cout % 8:
        raise ValueError(f"fused_double_conv: channel counts {cm}, {cout} must be multiples of 8")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError("fused_double_conv: all tensors must be on x's device")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"fused_double_conv: weights must be {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_double_conv: x must be channels_last (NHWC memory)")
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    w1k, b1f, w2k, b2f = packed if packed is not None else pack_double_conv(w1, b1, w2, b2)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        want = [(9, cm, _padded(cin)), (cm,), (9, cout, _padded(cm)), (cout,)]
    else:
        want = [(3, 3, cin, cm), (cm,), (3, 3, cm, cout), (cout,)]
    if [tuple(t.shape) for t in (w1k, b1f, w2k, b2f)] != want or any(
            t.dtype != d or t.device != x.device or not t.is_contiguous()
            for t, d in zip((w1k, b1f, w2k, b2f), (x.dtype, torch.float32) * 2)):
        raise ValueError("fused_double_conv: packed weights do not match pack_double_conv")
    mid = torch.empty((n, cm, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if bf16:
        symbol, k1, k2 = "ugpg_double_conv_bf16", conv_chunk(cin), conv_chunk(cm)
    else:
        symbol, k1, k2 = "ugpg_double_conv_f32", f32_plan(n, h, w, cm), f32_plan(n, h, w, cout)
    fn = _lib.function("double_conv", symbol, _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w1k.data_ptr(), b1f.data_ptr(), mid.data_ptr(), w2k.data_ptr(),
                b2f.data_ptr(), out.data_ptr(), n, h, w, cin, cm, cout, k1, k2, _lib.stream(x))
    _lib.check(rc, "double_conv", "fused_double_conv")
    _lib.count("fused_double_conv")
    return out
