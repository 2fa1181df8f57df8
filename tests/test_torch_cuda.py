"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 (TF32 off) 1e-4, since the kernel and cuDNN sum in
different orders; bfloat16 2e-2 of the largest output, since the rounded
middle activation of the double conv may land one bf16 step apart.  The
loss kernels: the two means to rtol 1e-5 (float32 terms; the kernel sums
them in float64, torch in float32), dx to 1e-5 x max|dx| (the same
float32 expression, evaluated in another order); repeats of the same call
bit-identical (a fixed order of sums, no float atomics).
"""

import pytest
import torch

from ugpg_tpu_torch.ops.cuda import _lib
from ugpg_tpu_torch.ops.cuda import double_conv as dc
from ugpg_tpu_torch.ops.cuda.double_conv import (
    f32_launches,
    fused_double_conv,
    fused_double_conv_reference,
    pack_double_conv,
)
from ugpg_tpu_torch.ops.cuda.resize2x import upsample2x, upsample2x_reference
from ugpg_tpu_torch.ops.cuda.uncertainty import (
    uncertainty_from_logits,
    uncertainty_from_logits_reference,
)
from ugpg_tpu_torch.ops.cuda.uncertainty_bce import (
    uncertainty_weighted_bce,
    uncertainty_weighted_bce_backward,
    uncertainty_weighted_bce_backward_reference,
    uncertainty_weighted_bce_forward,
    uncertainty_weighted_bce_reference,
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


def _kernels_in_profile(fn, calls):
    """Launches by kernel name in a torch.profiler window around ``calls``
    calls of ``fn`` (after one outside it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.cpu_time_total == 0 and e.self_device_time_total > 0
            and e.key != "Activity Buffer Request"}


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * max(1.0, scale), err
    else:
        assert err <= 2e-2 * max(1.0, scale), (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 256, 256), (3, 2, 33, 65), (1, 1, 1, 7),
                                   (1, 1, 256, 256), (64, 1, 256, 256)])  # serving buckets
def test_uncertainty_kernel(cuda, dtype, shape):
    x = (torch.randn(shape, device=cuda) * 4).to(dtype)
    got = uncertainty_from_logits(x)
    assert got.shape == x.shape and got.dtype == dtype and got.stride() == x.stride()
    _close(got, uncertainty_from_logits_reference(x), dtype)


def test_uncertainty_kernel_agrees_with_torch_sigmoid_to_a_few_ulp(cuda):
    # the same float32 expression with expf and IEEE division: a few ulp of
    # 1.0 at most, across the range where sigmoid saturates (|x| ~ 17)
    x = torch.linspace(-40.0, 40.0, 1 << 20, device=cuda)
    err = (uncertainty_from_logits(x) - uncertainty_from_logits_reference(x)).abs().max().item()
    assert err <= 4 * 2.0 ** -23, err


def _entry_launch(x, out):
    """The C entry called directly, with an output of the caller's choice."""
    from ugpg_tpu_torch.ops.cuda import uncertainty as unc

    fn = unc._entry or unc._bind()
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), _lib.dtype_code(x, "test"), _lib.stream(x))
    _lib.check(rc, "uncertainty", "test")
    return out


# (dtype, element offset off a 16-byte boundary, n): n % vec from 0 to vec - 1
# (vec = 4 float32, 8 bfloat16) past 4096, and every n shorter than a vector
_MISALIGNED = [(dtype, offset, n) for dtype, vec in ((torch.float32, 4), (torch.bfloat16, 8))
               for offset in (1, 2, 3)
               for n in [4096 + r for r in range(vec)] + list(range(1, vec))]


@pytest.mark.parametrize("dtype,offset,n", _MISALIGNED)
def test_uncertainty_kernel_misaligned_base_and_ragged_tail(cuda, dtype, offset, n):
    # x = buf[offset:] starts off a 16-byte boundary.  Through the wrapper
    # the fresh output is aligned, so every element takes the scalar walk;
    # through the C entry with an output at x's offset, the scalar
    # prologue, the vector walk and the n % vec epilogue; at another
    # offset, the scalar walk again
    buf = (torch.randn(n + offset + 1, device=cuda) * 4).to(dtype)
    x = buf[offset:offset + n]
    want = uncertainty_from_logits_reference(x)
    _close(uncertainty_from_logits(x), want, dtype)
    for out_offset in (offset, offset + 1):
        out = torch.full((n + offset + 1,), float("nan"), device=cuda, dtype=dtype)
        got = _entry_launch(x, out[out_offset:out_offset + n])
        _close(got, want, dtype)
        torch.cuda.synchronize()
        assert out[:out_offset].isnan().all() and out[out_offset + n:].isnan().all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uncertainty_kernel_keeps_channels_last(cuda, dtype):
    x = (torch.randn(3, 2, 33, 65, device=cuda) * 4).to(dtype).contiguous(memory_format=CL)
    got = uncertainty_from_logits(x)
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    _close(got, uncertainty_from_logits_reference(x), dtype)
    assert torch.equal(got, uncertainty_from_logits(x.contiguous()))


def test_uncertainty_kernel_takes_empty_tensors_without_a_launch(cuda):
    _lib.reset_launch_counts()
    for shape in ((0,), (2, 0, 4, 4)):
        for dtype in (torch.float32, torch.bfloat16):
            got = uncertainty_from_logits(torch.empty(shape, device=cuda, dtype=dtype))
            assert got.shape == shape and got.dtype == dtype and got.device.type == "cuda"
    assert _lib.launch_counts() == {}


def test_uncertainty_kernel_on_two_streams_at_once(cuda):
    inputs = (torch.randn(64, 1, 256, 256, device=cuda) * 4,
              (torch.randn(8, 1, 256, 256, device=cuda) * 4).bfloat16())
    want = [uncertainty_from_logits_reference(t) for t in inputs]
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(4):
        for i, (s, t) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append(uncertainty_from_logits(t))
    torch.cuda.synchronize()
    for outs, w, t in zip(got, want, inputs):
        for out in outs:
            _close(out, w, t.dtype)
            assert torch.equal(out, outs[0])


def test_uncertainty_kernel_repeats_to_the_same_bits(cuda):
    for x in (torch.randn(64, 1, 256, 256, device=cuda) * 4,
              (torch.randn(8, 1, 256, 256, device=cuda) * 4).bfloat16(),
              (torch.randn(4099, device=cuda) * 4)[1:]):
        first = uncertainty_from_logits(x)
        assert all(torch.equal(first, uncertainty_from_logits(x)) for _ in range(3))


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_uncertainty_kernel_is_one_launch_per_call(cuda, batch):
    # The wrapper's counter gives the launches (exact); the profiler shows
    # that the device ran the uncertainty kernel and nothing else.  Its
    # count is held to at most ``calls``: it lost a launch from a window
    # on an H100 (ROADMAP.md, section C), as in
    # test_uncertainty_bce_forward_is_one_kernel_launch.
    x = torch.randn(batch, 1, 256, 256, device=cuda)
    calls = 5
    _lib.reset_launch_counts()
    kernels = _kernels_in_profile(lambda: uncertainty_from_logits(x), calls)
    assert _lib.launch_counts() == {"uncertainty_from_logits": calls + 1}
    assert 0 < sum(kernels.values()) <= calls, kernels
    assert all("uncertainty_kernel" in k for k in kernels), kernels


def test_uncertainty_kernel_refuses_layouts_and_dtypes_it_does_not_take(cuda):
    x = torch.randn(2, 3, 8, 8, device=cuda)
    for bad in (x[:, :, ::2], x[..., 1:], x.transpose(2, 3)):  # not dense, or dense but permuted
        with pytest.raises(ValueError, match="contiguous or channels_last"):
            uncertainty_from_logits(bad)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        uncertainty_from_logits(x.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", [(8, 512, 16, 16), (8, 64, 128, 128), (2, 5, 1, 7),
                                     (1, 3, 9, 1),
                                     (2, 16, 1, 9),    # H = 1, 16-byte vectors
                                     (3, 24, 5, 1),    # W = 1
                                     (2, 12, 5, 7),    # float32 vectors, bf16 scalar
                                     (1, 8, 1, 1)])
def test_upsample2x_kernel(cuda, dtype, n, c, h, w):
    x = torch.randn(n, c, h, w, device=cuda).to(dtype).contiguous(memory_format=CL)
    got = upsample2x(x)
    assert got.is_contiguous(memory_format=CL) and got.shape == (n, c, 2 * h, 2 * w)
    _close(got, upsample2x_reference(x), dtype)


def _dc_inputs(device, dtype, n, h, w, cin, cm, cout):
    g = torch.Generator(device=device).manual_seed(h)
    x = torch.randn(n, cin, h, w, device=device, generator=g).to(dtype).contiguous(memory_format=CL)
    w1 = (torch.randn(cm, cin, 3, 3, device=device, generator=g) * (2 / (9 * cin)) ** 0.5).to(dtype)
    w2 = (torch.randn(cout, cm, 3, 3, device=device, generator=g) * (2 / (9 * cm)) ** 0.5).to(dtype)
    b1 = torch.randn(cm, device=device, generator=g) * 0.1
    b2 = torch.randn(cout, device=device, generator=g) * 0.1
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cm,cout", [
    (8, 256, 256, 3, 64, 64),      # inc
    (8, 16, 16, 512, 512, 512),    # down4: the 8x8 tile in float32
    (8, 32, 32, 1024, 256, 256),   # up1: Cin chunks
    (2, 37, 23, 20, 24, 16),       # ragged H and W, partial channel passes
    (1, 5, 3, 8, 8, 8),            # image smaller than a tile
    (3, 19, 45, 3, 24, 8),         # Cin = 3 (scalar staging), Cout = 8 < one N slice
    (1, 32, 32, 1024, 256, 8),     # batch 1, Cin = 1024 at 32 px
    (2, 17, 33, 64, 512, 64),      # Cm = 512 near 16 px, H and W past a tile
    (1, 16, 16, 512, 512, 512),    # batch 1, one whole tile
    (2, 40, 24, 128, 64, 64),      # H and W not multiples of the tile
    (1, 63, 63, 512, 512, 512),    # 63 px tails of the 8 x 16 tile, float32 BN 64
    (2, 9, 17, 8, 16, 8),          # 1 px tails in H and W
    (3, 63, 33, 20, 24, 24),       # batch 3, Cin = 20 (a partial K chunk), Cout = 24
    (2, 17, 1, 64, 96, 136),       # W = 1; Cout past one BN = 64 slice, not a multiple
])
def test_fused_double_conv_kernel(cuda, dtype, n, h, w, cin, cm, cout):
    x, w1, b1, w2, b2 = _dc_inputs(cuda, dtype, n, h, w, cin, cm, cout)
    got = fused_double_conv(x, w1, b1, w2, b2)
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    _close(got, fused_double_conv_reference(x, w1, b1, w2, b2), dtype)


# stage 4 at native resolution: a 1000 px MoNuSeg tile padded to 1008 px,
# float32 and batch 1, as MoNuSegEvaluator.evaluate_dataset_native and
# SlidePredictor run it -- odd sides (63, 126 ... 504) and their tile tails
NATIVE_DOUBLE_CONVS = [(1008, 3, 64, 64), (504, 64, 128, 128), (252, 128, 256, 256),
                       (126, 256, 512, 512), (63, 512, 512, 512), (126, 1024, 256, 256),
                       (252, 512, 128, 128), (504, 256, 64, 64), (1008, 128, 64, 64)]
NATIVE_UPSAMPLES = [(512, 63), (256, 126), (128, 252), (64, 504)]


@pytest.mark.parametrize("h,cin,cm,cout", NATIVE_DOUBLE_CONVS)
def test_fused_double_conv_kernel_at_native_evaluation_shapes(cuda, h, cin, cm, cout):
    x, w1, b1, w2, b2 = _dc_inputs(cuda, torch.float32, 1, h, h, cin, cm, cout)
    got = fused_double_conv(x, w1, b1, w2, b2)
    _close(got, fused_double_conv_reference(x, w1, b1, w2, b2), torch.float32)


def _f32_double_conv(x, w1, b1, w2, b2, bn):
    """The float32 C entry with both launches at ``bn`` output channels
    per block, whatever the plan would pick."""
    n, cin, h, w = x.shape
    cm, cout = w1.shape[0], w2.shape[0]
    w1k, b1k, w2k, b2k = pack_double_conv(w1, b1, w2, b2)
    mid = torch.empty((n, cm, h, w), device=x.device, memory_format=CL)
    out = torch.empty((n, cout, h, w), device=x.device, memory_format=CL)
    fn = _lib.function("double_conv", "ugpg_double_conv_f32", dc._ARGTYPES)
    rc = fn(x.data_ptr(), w1k.data_ptr(), b1k.data_ptr(), mid.data_ptr(), w2k.data_ptr(),
            b2k.data_ptr(), out.data_ptr(), n, h, w, cin, cm, cout, bn, bn, _lib.stream(x))
    _lib.check(rc, "double_conv", "test")
    return out


@pytest.mark.parametrize("bn", [32, 64])
@pytest.mark.parametrize("n,h,w,cin,cm,cout", [
    (1, 63, 63, 512, 512, 512),    # native down4
    (1, 126, 126, 256, 512, 512),  # native down3
    (8, 16, 16, 512, 512, 512),    # stage-4 down4 at batch 8
    (3, 63, 33, 20, 24, 24),       # batch 3, partial K chunk, Cout < BN
    (2, 9, 17, 3, 64, 8),          # Cin = 3 (4-byte staging), Cout = 8, 1 px tails
    (2, 17, 1, 64, 96, 136),       # W = 1, a ragged last channel slice
])
def test_float32_conv_at_each_block_width(cuda, bn, n, h, w, cin, cm, cout):
    # both BN values the plan can pick, at each shape, through the C entry
    args = _dc_inputs(cuda, torch.float32, n, h, w, cin, cm, cout)
    _close(_f32_double_conv(*args, bn), fused_double_conv_reference(*args), torch.float32)


def test_float32_double_conv_stages_x_off_16_bytes(cuda):
    # x one float past a 16-byte boundary: Cin % 4 == 0 but the 4-byte staging
    x, w1, b1, w2, b2 = _dc_inputs(cuda, torch.float32, 2, 19, 21, 16, 32, 16)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xs = buf[1:].view(2, 19, 21, 16).permute(0, 3, 1, 2)
    xs.copy_(x)
    assert xs.is_contiguous(memory_format=CL) and xs.data_ptr() % 16 == 4
    _close(fused_double_conv(xs, w1, b1, w2, b2), fused_double_conv_reference(x, w1, b1, w2, b2),
           torch.float32)


def test_float32_double_conv_is_two_launches_of_its_kernel(cuda):
    # The C side counts its launches (exact); the profiler shows that the
    # device ran the float32 conv kernel and nothing else.  Its count is
    # held to at most two per call: it has lost kernels from a window on an
    # H100 (ROADMAP.md, section C).
    # Weights packed ahead, as Predictor does: packing in the call launches
    # the HWIO copies as well.
    args = _dc_inputs(cuda, torch.float32, 1, 63, 63, 512, 512, 512)
    packed = pack_double_conv(*args[1:])
    calls = 5
    _lib.reset_launch_counts()
    before = f32_launches()
    kernels = _kernels_in_profile(lambda: fused_double_conv(*args, packed=packed), calls)
    assert f32_launches() - before == 2 * (calls + 1)
    assert _lib.launch_counts() == {"fused_double_conv": calls + 1}
    assert 0 < sum(kernels.values()) <= 2 * calls, kernels
    assert all("conv3x3_f32_kernel" in k for k in kernels), kernels
    bf = [t.bfloat16() if t.dtype == torch.float32 and t.dim() > 1 else t for t in args]
    before = f32_launches()
    fused_double_conv(bf[0].contiguous(memory_format=CL), *bf[1:])
    assert f32_launches() == before  # bf16 never takes the float32 kernel


@pytest.mark.parametrize("c,h", NATIVE_UPSAMPLES)
def test_upsample2x_kernel_at_native_evaluation_shapes(cuda, c, h):
    x = torch.randn(1, c, h, h, device=cuda).contiguous(memory_format=CL)
    _close(upsample2x(x), upsample2x_reference(x), torch.float32)


def test_uncertainty_kernel_at_the_native_evaluation_shape(cuda):
    x = torch.randn(1, 1, 1008, 1008, device=cuda) * 4
    _close(uncertainty_from_logits(x), uncertainty_from_logits_reference(x), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_kernels_repeat_to_the_same_bits(cuda, dtype):
    # no atomics: a repeated call gives the same bits; packing ahead of the
    # call (as Predictor does) gives the same bits as packing in it.  Both
    # dtypes, despite the name (kept from when only bf16 was checked)
    args = _dc_inputs(cuda, dtype, 2, 40, 24, 128, 64, 64)
    first = fused_double_conv(*args)
    assert torch.equal(first, fused_double_conv(*args))
    assert torch.equal(first, fused_double_conv(*args, packed=pack_double_conv(*args[1:])))
    x = torch.randn(4, 64, 32, 32, device=cuda).to(dtype).contiguous(memory_format=CL)
    assert torch.equal(upsample2x(x), upsample2x(x))


def test_fused_double_conv_refuses_packed_weights_of_another_layout(cuda):
    args = _dc_inputs(cuda, torch.bfloat16, 1, 8, 8, 20, 24, 8)
    w1k, b1k, w2k, b2k = pack_double_conv(*args[1:])
    for bad in ((w1k[:, :, :16].contiguous(), b1k, w2k, b2k),   # another K padding
                (w1k.float(), b1k, w2k, b2k),                   # another dtype
                pack_double_conv(*(t.float() for t in args[1:]))):  # the float32 layout
        with pytest.raises(ValueError, match="packed weights"):
            fused_double_conv(*args, packed=bad)


def _loss_inputs(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=g) * 4
    z = (torch.rand(shape, device=device, generator=g) > 0.6).float()
    p = torch.rand(shape, device=device, generator=g)
    return x, z, p


@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("shape", [(8, 1, 256, 256), (2, 1, 17, 19), (8, 1, 32, 32),
                                   (8, (1 << 21) + 1, 1, 1)])  # 2^24 + 8 elements
def test_uncertainty_bce_kernels(cuda, shape, alpha):
    x, z, p = _loss_inputs(shape, cuda)
    final, base = uncertainty_weighted_bce_forward(x, z, p, 5.0, alpha)
    want_final, want_base = uncertainty_weighted_bce_reference(x, z, p, 5.0, alpha)
    torch.cuda.synchronize()
    assert final.shape == base.shape == () and final.dtype == torch.float32
    torch.testing.assert_close(final, want_final, rtol=1e-5, atol=0)
    torch.testing.assert_close(base, want_base, rtol=1e-5, atol=0)
    again = uncertainty_weighted_bce_forward(x, z, p, 5.0, alpha)
    assert torch.equal(final, again[0]) and torch.equal(base, again[1])  # no atomics
    g = torch.tensor(1.7, device=cuda)
    dx = uncertainty_weighted_bce_backward(x, z, p, 5.0, alpha, g)
    want_dx = uncertainty_weighted_bce_backward_reference(x, z, p, 5.0, alpha, g)
    torch.cuda.synchronize()
    scale = want_dx.abs().max().item()
    assert (dx - want_dx).abs().max().item() <= 1e-5 * scale


def test_uncertainty_bce_keeps_the_last_element(cuda):
    n = (1 << 24) + 8  # a float32 index compare would drop elements past 2^24
    x, z, p = _loss_inputs((n,), cuda, seed=7)
    final, _ = uncertainty_weighted_bce_forward(x, z, p, 5.0, 1.0)
    old, _ = uncertainty_weighted_bce_reference(x[-1:], z[-1:], p[-1:], 5.0, 1.0)
    # a logit of -1e4 at z=1: a pixel loss of 5e4 that moves the mean by
    # about 6e-3, far above its float32 rounding (a loss near zero would
    # move the mean by less than one ulp)
    x[-1], z[-1], p[-1] = -1e4, 1.0, 0.5
    final2, _ = uncertainty_weighted_bce_forward(x, z, p, 5.0, 1.0)
    want2, _ = uncertainty_weighted_bce_reference(x, z, p, 5.0, 1.0)
    new, _ = uncertainty_weighted_bce_reference(x[-1:], z[-1:], p[-1:], 5.0, 1.0)
    torch.cuda.synchronize()
    delta = (new.item() - old.item()) / n
    assert abs((final2.item() - final.item()) - delta) <= 1e-3 * delta
    assert abs(final2.item() - want2.item()) <= 1e-5 * abs(want2.item())


def test_uncertainty_bce_function_runs_both_kernels(cuda):
    x, z, p = _loss_inputs((4, 1, 64, 64), cuda, seed=3)
    xk = x.clone().requires_grad_()
    xr = x.clone().requires_grad_()
    _lib.reset_launch_counts()
    final, base = uncertainty_weighted_bce(xk, z, p[:1], 5.0, 1.0)  # p broadcasts
    final.backward()
    assert _lib.launch_counts() == {"uncertainty_weighted_bce_fwd": 1,
                                    "uncertainty_weighted_bce_bwd": 1}
    want, _ = uncertainty_weighted_bce_reference(xr, z, p[:1].expand_as(x), 5.0, 1.0)
    want.backward()
    torch.testing.assert_close(final, want.detach(), rtol=1e-5, atol=0)
    assert (xk.grad - xr.grad).abs().max().item() <= 1e-5 * xr.grad.abs().max().item()
    assert not base.requires_grad


def _assert_loss_matches_plain(x, z, p, alpha, got=None):
    final, base = got if got is not None else uncertainty_weighted_bce_forward(x, z, p, 5.0, alpha)
    want_final, want_base = uncertainty_weighted_bce_reference(x, z, p, 5.0, alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(final, want_final, rtol=1e-5, atol=0)
    torch.testing.assert_close(base, want_base, rtol=1e-5, atol=0)
    return final, base


def test_uncertainty_bce_forward_resets_its_ticket_between_sizes(cuda):
    # the last block puts the ticket back to 0: calls of another size (so
    # another grid) in turn keep matching the plain version
    inputs = {n: _loss_inputs((n,), cuda, seed=n % 97) for n in (8192, 524288, 17 * 19 * 2)}
    first = {}
    for rnd in range(2):
        for alpha in (1.0, 0.0):
            for n, (x, z, p) in inputs.items():
                got = _assert_loss_matches_plain(x, z, p, alpha)
                if rnd == 0:
                    first[n, alpha] = got
                else:
                    assert all(torch.equal(a, b) for a, b in zip(got, first[n, alpha]))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [4096, 4097, 4098, 4099, 3, 1])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_uncertainty_bce_misaligned_base_and_ragged_tail(cuda, offset, n, alpha):
    # x[offset:] of a flat tensor starts off a 16-byte boundary: the scalar
    # prologue, the float4 walk and the n % 4 epilogue; z and p sliced alike
    # walk together, a z at another offset takes the all-scalar walk
    xf, zf, pf = _loss_inputs((n + offset,), cuda, seed=n + offset)
    x, z, p = xf[offset:], zf[offset:], pf[offset:]
    g = torch.tensor(0.3, device=cuda)
    for zz in (z, z.clone()):
        _assert_loss_matches_plain(x, zz, p, alpha)
        dx = uncertainty_weighted_bce_backward(x, zz, p, 5.0, alpha, g)
        want = uncertainty_weighted_bce_backward_reference(x, zz, p, 5.0, alpha, g)
        torch.cuda.synchronize()
        assert (dx - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_uncertainty_bce_forwards_on_two_streams_at_once(cuda):
    # each stream has its own workspace and ticket
    a = _loss_inputs((1 << 22,), cuda, seed=11)
    b = _loss_inputs((1 << 20,), cuda, seed=12)
    want = [uncertainty_weighted_bce_reference(*t, 5.0, 1.0) for t in (a, b)]
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(4):
        for i, (s, t) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(s):
                got[i].append(uncertainty_weighted_bce_forward(*t, 5.0, 1.0))
    torch.cuda.synchronize()
    for outs, (wf, wb) in zip(got, want):
        for final, base in outs:
            torch.testing.assert_close(final, wf, rtol=1e-5, atol=0)
            torch.testing.assert_close(base, wb, rtol=1e-5, atol=0)
            assert torch.equal(final, outs[0][0]) and torch.equal(base, outs[0][1])


@pytest.mark.parametrize("shape", [(8, 1, 32, 32), (8, 1, 256, 256), (2, 1, 17, 19)])
def test_uncertainty_bce_zero_dim_p_at_alpha_zero_equals_the_full_half_map(cuda, shape):
    x, z, _ = _loss_inputs(shape, cuda, seed=5)
    results = []
    for p in (torch.tensor(0.5, device=cuda), torch.full_like(x, 0.5)):
        xg = x.clone().requires_grad_()
        final, base = uncertainty_weighted_bce(xg, z, p, 5.0, 0.0)
        final.backward()
        results.append((final.detach(), base, xg.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(*results))
    assert torch.equal(results[0][0], results[0][1])  # weight 1: final is base
    _assert_loss_matches_plain(x, z, torch.full_like(x, 0.5), 0.0, got=results[0][:2])


def test_uncertainty_bce_forward_is_one_kernel_launch(cuda):
    # The wrapper's counter gives the launches; the profiler shows that the
    # device ran no other kernel and no second forward.  Its count is held
    # to at most ``calls``: windows of this test lost exactly one forward
    # kernel in three runs in a row on an H100 (torch 2.11.0+cu128), 4 of 5
    # and 19 of 20, taken once more or not.
    x, z, p = _loss_inputs((8, 1, 256, 256), cuda, seed=9)
    calls = 5
    for alpha in (1.0, 0.0):
        # the first call, outside the window, allocates the workspace
        _lib.reset_launch_counts()
        kernels = _kernels_in_profile(
            lambda: uncertainty_weighted_bce_forward(x, z, p, 5.0, alpha), calls)
        assert _lib.launch_counts() == {"uncertainty_weighted_bce_fwd": calls + 1}
        assert 0 < sum(kernels.values()) <= calls, kernels
        assert all("bce_forward" in k for k in kernels), kernels


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
    with pytest.raises(ValueError, match="contiguous"):
        uncertainty_weighted_bce_forward(xc, xc, xc, 5.0, 1.0)  # channels_last, C > 1
    with pytest.raises(TypeError, match="float32"):
        uncertainty_weighted_bce_forward(x.double(), x.double(), x.double(), 5.0, 1.0)
    uncertainty_weighted_bce_forward(x, x, x, 5.0, 1.0)
    uncertainty_weighted_bce_backward(x, x, x, 5.0, 1.0, torch.ones((), device=cuda))
    torch.cuda.synchronize()
    assert _lib.launch_counts() == {
        "fused_double_conv": 1, "upsample2x": 1, "uncertainty_from_logits": 1,
        "uncertainty_weighted_bce_fwd": 1, "uncertainty_weighted_bce_bwd": 1}


# ---------------------------------------------------------------- the operators and the artifacts
# the operators of ops/cuda/library.py at the stage-4 serving shapes: the
# CUDA implementation (the kernel) against the CPU one (the plain version),
# with the tolerances above
SERVING_DOUBLE_CONVS = [(256, 3, 64, 64), (128, 64, 128, 128), (64, 128, 256, 256),
                        (32, 256, 512, 512), (16, 512, 512, 512), (32, 1024, 256, 256),
                        (64, 512, 128, 128), (128, 256, 64, 64), (256, 128, 64, 64)]
SERVING_UPSAMPLES = [(512, 16), (256, 32), (128, 64), (64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cin,cm,cout", SERVING_DOUBLE_CONVS)
def test_double_conv_operator_on_the_card_against_the_cpu(cuda, dtype, h, cin, cm, cout):
    from ugpg_tpu_torch.ops.cuda import library

    args = _dc_inputs(cuda, dtype, 2, h, h, cin, cm, cout)
    _lib.reset_launch_counts()
    got = library.fused_double_conv(*args, *pack_double_conv(*args[1:]))
    assert _lib.launch_counts() == {"fused_double_conv": 1}
    want = library.fused_double_conv(*(t.cpu() for t in args), None, None, None, None)
    assert got.is_contiguous(memory_format=CL) and want.is_contiguous(memory_format=CL)
    _close(got, want.to(cuda), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", SERVING_UPSAMPLES)
def test_upsample_operator_on_the_card_against_the_cpu(cuda, dtype, c, h):
    from ugpg_tpu_torch.ops.cuda import library

    x = torch.randn(2, c, h, h, device=cuda).to(dtype).contiguous(memory_format=CL)
    _lib.reset_launch_counts()
    got = library.upsample2x(x)
    assert _lib.launch_counts() == {"upsample2x": 1}
    _close(got, library.upsample2x(x.cpu()).to(cuda), dtype)


@pytest.mark.parametrize("n,c,h,w", [(2, c, h, h) for c, h in SERVING_UPSAMPLES]
                         + [(3, 5, 1, 7), (2, 12, 9, 4), (1, 8, 1, 1)])
def test_upsample_bf16_taps_operator_on_the_card_against_the_cpu(cuda, n, c, h, w):
    """The bf16-taps instance (JAX's bf16 resize rounding) equals its plain
    version bit for bit, on the card and on the CPU: each output is at most
    two exact bf16 x bf16 products summed once in float32, per pass."""
    from ugpg_tpu_torch.ops.cuda import library
    from ugpg_tpu_torch.ops.cuda.resize2x import upsample2x_bf16_taps_reference

    x = (torch.randn(n, c, h, w, device=cuda) * 3).bfloat16().contiguous(memory_format=CL)
    _lib.reset_launch_counts()
    got = library.upsample2x_bf16_taps(x)
    assert _lib.launch_counts() == {"upsample2x_bf16_taps": 1}
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, upsample2x_bf16_taps_reference(x))
    assert torch.equal(got.cpu(), library.upsample2x_bf16_taps(x.cpu()))
    with pytest.raises(TypeError, match="bfloat16"):
        library.upsample2x_bf16_taps(x.float())


@pytest.mark.parametrize("batch", [1, 64])
def test_uncertainty_operator_on_the_card_against_the_cpu(cuda, batch):
    from ugpg_tpu_torch.ops.cuda import library

    x = torch.randn(batch, 1, 256, 256, device=cuda) * 4
    _lib.reset_launch_counts()
    got = library.uncertainty_from_logits(x)
    assert _lib.launch_counts() == {"uncertainty_from_logits": 1}
    _close(got, library.uncertainty_from_logits(x.cpu()).to(cuda), torch.float32)


def test_exported_artifact_runs_the_kernels(cuda, tmp_path):
    """A stage-4 float32 artifact exported on the card: bit-identical to
    the live Predictor there, 9 double-conv, 4 upsample and 1 uncertainty
    launches per device call (the wrappers' counts) and 18 float32-conv
    launches (the C side's); loaded on the CPU, within 1e-4 of the live
    CPU Predictor."""
    import numpy as np

    from ugpg_tpu_torch.eval.exported import ExportedPredictor
    from ugpg_tpu_torch.eval.serving import Predictor
    from ugpg_tpu_torch.io.checkpoint import save_checkpoint
    from ugpg_tpu_torch.models.blocks import init_parameters
    from ugpg_tpu_torch.models.pgunet import PGUNet4

    model = PGUNet4(use_bn=True)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "s4.pth", model.state_dict(), stage=4, epoch=0)
    live = Predictor(str(tmp_path / "s4.pth"), buckets=(2,), dtype=None)
    served = ExportedPredictor(live.export(tmp_path / "art"))
    x = np.random.default_rng(0).random((2, 256, 256, 3), dtype=np.float32)
    want = live(x)
    _lib.reset_launch_counts()
    f32_before = f32_launches()
    got = served(x)
    torch.cuda.synchronize()
    assert _lib.launch_counts() == {"fused_double_conv": 9, "upsample2x": 4,
                                    "uncertainty_from_logits": 1}
    assert f32_launches() - f32_before == 18
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cpu = ExportedPredictor(tmp_path / "art", device="cpu")(x)
    live_cpu = Predictor(str(tmp_path / "s4.pth"), buckets=(2,), dtype=None, device="cpu")(x)
    np.testing.assert_allclose(cpu[1], live_cpu[1], atol=1e-4, rtol=0)


# ---------------------------------------------------------------- conv3x3: one launch
# (n, h, w, cin, cout): the stage-4 convs as the spatially sharded forward
# launches them on a shard of a 1024 px slide on a 2 x 2 grid (the local
# extent plus its 1-px inner halo), then half-channel slices of the widest
# convs as the column-parallel convs launch them (a model axis of 2)
CONV3X3_SHAPES = [
    (1, 513, 513, 3, 64),      # inc conv1, one halo row and column
    (1, 257, 257, 64, 128),    # down1 conv1
    (1, 65, 65, 512, 512),     # down4 conv1
    (1, 33, 33, 512, 512),     # down4 conv2 at 1008 / 2 px / 16
    (1, 129, 129, 1024, 256),  # up1 conv1
    (8, 32, 32, 3, 256),       # stage 1 inc conv1, half of 512
    (8, 16, 16, 512, 256),     # stage 1 down4, half of 512
    (8, 32, 32, 1024, 128),    # stage 1 up1, half of 256
    (2, 17, 33, 20, 24),       # ragged tiles, a partial K chunk, Cout < one block
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", CONV3X3_SHAPES)
def test_conv3x3_kernel(cuda, dtype, n, h, w, cin, cout):
    """One launch against its plain version: in bf16 the kernel's own order
    of sums (``conv3x3_packed_reference``), in float32 ``F.conv2d``; the
    wrapper and, in float32, the C side count it."""
    x, w1, b1, _, _ = _dc_inputs(cuda, dtype, n, h, w, cin, cout, 8)
    packed = (dc.pack_conv(w1), b1.float().contiguous())
    _lib.reset_launch_counts()
    before = f32_launches()
    got = dc.conv3x3(x, w1, b1, packed=packed)
    assert _lib.launch_counts() == {"conv3x3": 1}
    assert f32_launches() - before == int(dtype == torch.float32)
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    if dtype == torch.bfloat16:
        want = dc.conv3x3_packed_reference(x, dc.pack_conv3x3(w1), b1).to(dtype)
    else:
        want = dc.conv3x3_reference(x, w1, b1)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_channel_slices_make_the_whole(cuda, dtype):
    """The column-parallel split: each half of the output channels, launched
    on its own, is that half of the whole conv."""
    x, w1, b1, _, _ = _dc_inputs(cuda, dtype, 2, 16, 16, 512, 512, 8)
    whole = dc.conv3x3(x, w1, b1)
    halves = [dc.conv3x3(x, w1[s].contiguous(), b1[s].contiguous())
              for s in (slice(0, 256), slice(256, 512))]
    _close(torch.cat(halves, dim=1), whole, dtype)


def test_conv3x3_operator_and_refusals(cuda):
    from ugpg_tpu_torch.ops.cuda import library

    x, w1, b1, _, _ = _dc_inputs(cuda, torch.float32, 2, 19, 21, 16, 32, 8)
    got = library.conv3x3(x, w1, b1, dc.pack_conv(w1), b1.float().contiguous())
    want = library.conv3x3(*(t.cpu() for t in (x, w1, b1)), None, None)
    _close(got, want.to(cuda), torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        dc.conv3x3(x.contiguous(), w1, b1)
    with pytest.raises(ValueError, match="multiple of 8"):
        dc.conv3x3(x, w1[:4], b1[:4])
    with pytest.raises(ValueError, match="pack_conv"):
        dc.conv3x3(x, w1, b1, packed=(w1, b1))


# ---------------------------------------------------------------- CUDA graphs of the loss kernels
def test_uncertainty_bce_captured_and_replayed_equals_eager_calls(cuda):
    """The loss kernels recorded into a CUDA graph: every replay on new
    inputs (copied into the graph's buffers) equals the eager calls on those
    inputs bit for bit; the capture counts one launch of each into its own
    tally, not into the run's counts, and its workspace is the one made
    before the capture on that stream."""
    from ugpg_tpu_torch.ops.cuda import uncertainty_bce as ub

    shape = (8, 1, 64, 64)
    x, z, p = (t.clone() for t in _loss_inputs(shape, cuda, seed=21))
    g = torch.tensor(1.0, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ub.prepare_workspace(cuda)
        uncertainty_weighted_bce_forward(x, z, p, 5.0, 1.0)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    workspaces = dict(ub._workspaces)
    _lib.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with _lib.recording() as tally, torch.cuda.graph(graph, stream=side):
        final, base = uncertainty_weighted_bce_forward(x, z, p, 5.0, 1.0)
        dx = uncertainty_weighted_bce_backward(x, z, p, 5.0, 1.0, g)
    assert tally == {"uncertainty_weighted_bce_fwd": 1, "uncertainty_weighted_bce_bwd": 1}
    assert _lib.launch_counts() == {} and ub._workspaces == workspaces
    for seed in (22, 23, 24):
        for dst, src in zip((x, z, p), _loss_inputs(shape, cuda, seed=seed)):
            dst.copy_(src)
        graph.replay()
        _lib.add_launches(tally)
        want = uncertainty_weighted_bce_forward(x, z, p, 5.0, 1.0)
        want_dx = uncertainty_weighted_bce_backward(x, z, p, 5.0, 1.0, g)
        torch.cuda.synchronize()
        assert torch.equal(final, want[0]) and torch.equal(base, want[1])
        assert torch.equal(dx, want_dx)
    assert _lib.launch_counts() == {"uncertainty_weighted_bce_fwd": 6,
                                    "uncertainty_weighted_bce_bwd": 6}


def test_uncertainty_bce_capture_without_a_workspace_raises(cuda):
    """On a stream with no workspace the forward refuses to be captured
    (it would allocate and zero it inside the graph) and names the cure."""
    from ugpg_tpu_torch.ops.cuda import uncertainty_bce as ub

    x, z, p = _loss_inputs((4, 1, 16, 16), cuda, seed=25)
    side = torch.cuda.Stream()
    before = dict(ub._workspaces)
    with pytest.raises(RuntimeError, match="prepare_workspace"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            uncertainty_weighted_bce_forward(x, z, p, 5.0, 1.0)
    assert ub._workspaces == before


def test_scan_epochs_replay_a_graph_and_equal_the_per_step_path(cuda):
    """``scan_epochs`` on the card: the chunks' steps replay a CUDA graph
    (three warm-up steps, one capture per stage and kind) and the epochs
    equal the per-step path of a trainer built the same way (its optimizer
    torch's capturable variant) bit for bit (cuDNN deterministic), the
    ragged tail included; one loss forward and backward per train step.  A
    trainer built without ``scan_epochs`` keeps the host-float optimizer."""
    import numpy as np

    from ugpg_tpu_torch.data.synthetic import disk_dataset
    from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        images, masks = disk_dataset(8 * 8 + 4, 32, seed=3)
        images = images + np.random.default_rng(0).normal(0, 0.05, images.shape).astype(
            np.float32)
        batches = [(images[i:i + 8], masks[i:i + 8]) for i in range(0, 68, 8)]
        cfgs = {1: {"resolution": 16, "epochs_per_stage": 1, "lr": 3e-4},
                2: {"resolution": 32, "epochs_per_stage": 1, "lr": 1e-4}}
        per = images[:8].nbytes + masks[:8].nbytes
        runs = []
        for scan in (False, True):
            tr = UncertaintyGuidedProgressiveTrainer(
                stage_configs=cfgs, verbose=False, width=0.25, augment=True, fused_loss=True,
                scan_epochs=True, scan_chunk_bytes=4 * per)
            tr.scan_epochs = scan  # off: the per-step path, on the same optimizer variant
            out = []
            for stage in (1, 2):
                if stage > 1:
                    tr.transfer_weights(1, 2)
                tr.setup_optimizer(stage)
                for _ in range(2):
                    _lib.reset_launch_counts()
                    out.append(tr.train_epoch(batches, stage))
                    counts = _lib.launch_counts()
                    out.append(tr.validate_epoch(batches, stage))
            runs.append((tr, out, counts))
        (loop, want, want_counts), (scan, got, got_counts) = runs
        assert got == want
        assert got_counts == want_counts == {"uncertainty_weighted_bce_fwd": 9,
                                             "uncertainty_weighted_bce_bwd": 9}
        for (name, a), b in zip(loop.models[2].state_dict().items(),
                                scan.models[2].state_dict().values()):
            assert torch.equal(a, b), name
        graph = scan._epochs[(2, "train", False)].graph
        assert graph.captures == 1 and graph.eager_steps == 3 and graph.replays == 2 * 8 - 3
        assert graph.launches == {"uncertainty_weighted_bce_fwd": 1,
                                  "uncertainty_weighted_bce_bwd": 1}
        torch.backends.cudnn.deterministic = False  # other kernels: a new capture
        scan.train_epoch(batches, 2)
        assert graph.captures == 2 and graph.eager_steps == 6
        for flag, capturable in ((False, False), (True, True)):
            tr = UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, verbose=False,
                                                     width=0.25, scan_epochs=flag)
            assert tr.setup_optimizer(1).param_groups[0]["capturable"] is capturable
    finally:
        torch.backends.cudnn.deterministic = prev
