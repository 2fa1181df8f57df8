"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 (TF32 off) 1e-4, since the kernel and cuDNN sum in
different orders; bfloat16 2e-2 of the largest output, since the rounded
middle activation of the double conv may land one bf16 step apart.
"""

import pytest
import torch

from ugpg_tpu_torch.ops.cuda import _lib
from ugpg_tpu_torch.ops.cuda.double_conv import fused_double_conv, fused_double_conv_reference
from ugpg_tpu_torch.ops.cuda.resize2x import upsample2x, upsample2x_reference
from ugpg_tpu_torch.ops.cuda.uncertainty import (
    uncertainty_from_logits,
    uncertainty_from_logits_reference,
)

pytestmark = pytest.mark.cuda
CL = torch.channels_last


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * max(1.0, scale), err
    else:
        assert err <= 2e-2 * max(1.0, scale), (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 256, 256), (3, 2, 33, 65), (1, 1, 1, 7)])
def test_uncertainty_kernel(cuda, dtype, shape):
    x = (torch.randn(shape, device=cuda) * 4).to(dtype)
    _close(uncertainty_from_logits(x), uncertainty_from_logits_reference(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", [(8, 512, 16, 16), (8, 64, 128, 128), (2, 5, 1, 7),
                                     (1, 3, 9, 1)])
def test_upsample2x_kernel(cuda, dtype, n, c, h, w):
    x = torch.randn(n, c, h, w, device=cuda).to(dtype).contiguous(memory_format=CL)
    got = upsample2x(x)
    assert got.is_contiguous(memory_format=CL) and got.shape == (n, c, 2 * h, 2 * w)
    _close(got, upsample2x_reference(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cm,cout", [
    (8, 256, 256, 3, 64, 64),      # inc
    (8, 16, 16, 512, 512, 512),    # down4: the 8x8 tile in float32
    (8, 32, 32, 1024, 256, 256),   # up1: Cin chunks
    (2, 37, 23, 20, 24, 16),       # ragged H and W, partial channel passes
    (1, 5, 3, 8, 8, 8),            # image smaller than a tile
])
def test_fused_double_conv_kernel(cuda, dtype, n, h, w, cin, cm, cout):
    g = torch.Generator(device=cuda).manual_seed(h)
    x = torch.randn(n, cin, h, w, device=cuda, generator=g).to(dtype).contiguous(memory_format=CL)
    w1 = (torch.randn(cm, cin, 3, 3, device=cuda, generator=g) * (2 / (9 * cin)) ** 0.5).to(dtype)
    w2 = (torch.randn(cout, cm, 3, 3, device=cuda, generator=g) * (2 / (9 * cm)) ** 0.5).to(dtype)
    b1 = torch.randn(cm, device=cuda, generator=g) * 0.1
    b2 = torch.randn(cout, device=cuda, generator=g) * 0.1
    got = fused_double_conv(x, w1, b1, w2, b2)
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    _close(got, fused_double_conv_reference(x, w1, b1, w2, b2), dtype)


def test_kernels_count_launches_and_check_layout(cuda):
    _lib.reset_launch_counts()
    x = torch.randn(1, 8, 4, 4, device=cuda)
    w = torch.randn(8, 8, 3, 3, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        fused_double_conv(x, w, b, w, b)  # NCHW memory
    with pytest.raises(ValueError, match="channels_last"):
        upsample2x(x)
    xc = x.contiguous(memory_format=CL)
    fused_double_conv(xc, w, b, w, b)
    upsample2x(xc)
    uncertainty_from_logits(x)
    torch.cuda.synchronize()
    assert _lib.launch_counts() == {
        "fused_double_conv": 1, "upsample2x": 1, "uncertainty_from_logits": 1}
