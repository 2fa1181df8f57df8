"""The serving kernels as PyTorch operators (``ops/cuda/library.py``),
on the CPU.

``torch.library.opcheck`` holds each operator's schema, fake (meta)
implementation and dispatch together at small shapes; the fake outputs
have the real ones' shapes, dtypes and strides (``channels_last`` for the
double conv and the upsample, as the kernels write NHWC memory; the
uncertainty map keeps its input's strides; the single conv as the double
conv).  The CPU implementations are
the plain versions, exactly; an exported graph keeps each operator as one
call.  The kernels themselves run in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from ugpg_tpu_torch.models.pgunet import PGUNet2
from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.cuda.double_conv import (
    conv3x3_reference,
    fused_double_conv_reference,
    pack_conv,
    pack_double_conv,
)
from ugpg_tpu_torch.ops.cuda.resize2x import (
    _tap_weights,
    upsample2x_bf16_taps_reference,
    upsample2x_reference,
)
from ugpg_tpu_torch.ops.cuda.uncertainty import uncertainty_from_logits_reference

CL = torch.channels_last
OPS = torch.ops.ugpg_torch


def _double_conv_args(dtype, packed, layout):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 7, 9, generator=g).to(dtype)
    x = x.contiguous(memory_format=layout)
    w1 = (torch.randn(8, 5, 3, 3, generator=g) * 0.3).to(dtype)
    w2 = (torch.randn(16, 8, 3, 3, generator=g) * 0.3).to(dtype)
    b1, b2 = torch.randn(8, generator=g), torch.randn(16, generator=g)
    pk = pack_double_conv(w1, b1, w2, b2) if packed else (None,) * 4
    return (x, w1, b1, w2, b2, *pk)


def _conv_args(dtype, packed, layout):
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 5, 6, 9, generator=g).to(dtype).contiguous(memory_format=layout)
    w = (torch.randn(16, 5, 3, 3, generator=g) * 0.3).to(dtype)
    b = torch.randn(16, generator=g)
    return (x, w, b, *((pack_conv(w), b) if packed else (None, None)))


CASES = [
    ("conv3x3", "float32-packed-cl", lambda: _conv_args(torch.float32, True, CL)),
    ("conv3x3", "bfloat16-unpacked-nchw",
     lambda: _conv_args(torch.bfloat16, False, torch.contiguous_format)),
    ("double_conv", "float32-packed-cl", lambda: _double_conv_args(torch.float32, True, CL)),
    ("double_conv", "float32-unpacked-nchw",
     lambda: _double_conv_args(torch.float32, False, torch.contiguous_format)),
    ("double_conv", "bfloat16-packed-cl", lambda: _double_conv_args(torch.bfloat16, True, CL)),
    ("upsample", "float32-cl",
     lambda: (torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(1))
              .contiguous(memory_format=CL),)),
    ("upsample", "bfloat16-nchw",
     lambda: (torch.randn(1, 4, 3, 6, generator=torch.Generator().manual_seed(2))
              .to(torch.bfloat16),)),
    ("upsample_bf16_taps", "bfloat16-cl",
     lambda: ((torch.randn(2, 5, 1, 7, generator=torch.Generator().manual_seed(6)) * 3)
              .to(torch.bfloat16).contiguous(memory_format=CL),)),
    ("upsample_bf16_taps", "bfloat16-nchw",
     lambda: ((torch.randn(1, 4, 9, 6, generator=torch.Generator().manual_seed(7)) * 3)
              .to(torch.bfloat16),)),
    ("uncertainty", "float32-nchw",
     lambda: (torch.randn(2, 1, 8, 8, generator=torch.Generator().manual_seed(3)) * 4,)),
    ("uncertainty", "float32-cl",
     lambda: ((torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(4)) * 4)
              .contiguous(memory_format=CL),)),
    ("uncertainty", "bfloat16",
     lambda: ((torch.randn(3, 17, generator=torch.Generator().manual_seed(5)) * 4)
              .to(torch.bfloat16),)),
]
OP = {"double_conv": OPS.fused_double_conv.default, "conv3x3": OPS.conv3x3.default,
      "upsample": OPS.upsample2x.default,
      "upsample_bf16_taps": OPS.upsample2x_bf16_taps.default,
      "uncertainty": OPS.uncertainty_from_logits.default}
PLAIN = {
    "double_conv": lambda x, w1, b1, w2, b2, *_: fused_double_conv_reference(x, w1, b1, w2, b2),
    "conv3x3": lambda x, w, b, *_: conv3x3_reference(x, w, b),
    "upsample": upsample2x_reference,
    "upsample_bf16_taps": upsample2x_bf16_taps_reference,
    "uncertainty": uncertainty_from_logits_reference,
}


@pytest.mark.parametrize("kind,label,make", CASES, ids=[f"{k}-{lb}" for k, lb, _ in CASES])
def test_opcheck(kind, label, make):
    """Schema, autograd registration, fake tensor and AOT dispatch with
    dynamic shapes, all of opcheck's tests."""
    result = torch.library.opcheck(OP[kind], make())
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("kind,label,make", CASES, ids=[f"{k}-{lb}" for k, lb, _ in CASES])
def test_cpu_implementation_is_the_plain_version(kind, label, make):
    args = make()
    got, want = OP[kind](*args), PLAIN[kind](*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)  # the plain version itself, in its own layout or NHWC
    if kind == "uncertainty":
        assert got.stride() == args[0].stride()
    else:
        assert got.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("kind,label,make", CASES, ids=[f"{k}-{lb}" for k, lb, _ in CASES])
def test_fake_shapes_and_layout(kind, label, make):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = make()
    real = OP[kind](*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = OP[kind](*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype
    assert fake.stride() == real.stride()
    if kind != "uncertainty":
        assert fake.is_contiguous(memory_format=CL)


def test_exported_graph_keeps_each_operator_as_one_call():
    """A BN-folded stage-2 model traces to 5 double-conv and 2 upsample
    calls of the operators, no conv2d, and runs the same as eager."""
    torch.manual_seed(0)
    model = PGUNet2(use_bn=False, width=0.25).eval()
    for block in model.modules():
        if hasattr(block, "pack"):
            block.pack()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 16, 16), dtype=np.float32))
    x = x.contiguous(memory_format=CL)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
        want = model(x)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(OPS.fused_double_conv.default) == 5
    assert targets.count(OPS.upsample2x.default) == 2
    assert not [t for t in targets if "conv" in str(t) and "ugpg_torch" not in str(t)]
    assert torch.equal(program.module()(x), want)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 7), (9, 4), (16, 16), (37, 5)])
def test_bf16_taps_tables_give_the_plain_version_bit_for_bit(h, w):
    """The bf16-taps kernel's arithmetic, in torch on the CPU: per pass each
    output is w0 x tap0 + w1 x tap1 from ``_tap_weights`` (both products
    exact in float32), rounded to bf16, H before W.  It equals the plain
    version (JAX's bf16 einsums) bit for bit."""
    x = (torch.randn(2, 3, h, w, generator=torch.Generator().manual_seed(h * w)) * 3)
    x = x.bfloat16()
    t = _tap_weights(h, w, torch.device("cpu"))
    th, tw = t[:4 * h].view(4, h), t[4 * h:].view(4, w)

    def lerp(v, taps, dim, size):
        k = torch.arange(size)
        lo = v.index_select(dim, (k - 1).clamp(min=0))
        hi = v.index_select(dim, (k + 1).clamp(max=size - 1))
        shape = [1] * v.dim()
        shape[dim] = size
        e0, e1, o0, o1 = (r.view(shape) for r in taps)
        even = (e0 * lo + e1 * v).bfloat16().float()
        odd = (o0 * v + o1 * hi).bfloat16().float()
        return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)

    got = lerp(lerp(x.float(), th, 2, h), tw, 3, w).bfloat16()
    assert torch.equal(got, upsample2x_bf16_taps_reference(x))
    assert torch.equal(got, OPS.upsample2x_bf16_taps.default(x))
