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
from ugpg_tpu_torch.ops.cuda.double_conv import (
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
    x = torch.randn(batch, 1, 256, 256, device=cuda)
    calls = 5
    kernels = _kernels_in_profile(lambda: uncertainty_from_logits(x), calls)
    assert sum(kernels.values()) == calls, kernels
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


@pytest.mark.parametrize("c,h", NATIVE_UPSAMPLES)
def test_upsample2x_kernel_at_native_evaluation_shapes(cuda, c, h):
    x = torch.randn(1, c, h, h, device=cuda).contiguous(memory_format=CL)
    _close(upsample2x(x), upsample2x_reference(x), torch.float32)


def test_uncertainty_kernel_at_the_native_evaluation_shape(cuda):
    x = torch.randn(1, 1, 1008, 1008, device=cuda) * 4
    _close(uncertainty_from_logits(x), uncertainty_from_logits_reference(x), torch.float32)


def test_bf16_kernels_repeat_to_the_same_bits(cuda):
    # no atomics: a repeated call gives the same bits; packing ahead of the
    # call (as Predictor does) gives the same bits as packing in it
    args = _dc_inputs(cuda, torch.bfloat16, 2, 40, 24, 128, 64, 64)
    first = fused_double_conv(*args)
    assert torch.equal(first, fused_double_conv(*args))
    assert torch.equal(first, fused_double_conv(*args, packed=pack_double_conv(*args[1:])))
    x = torch.randn(4, 64, 32, 32, device=cuda).bfloat16().contiguous(memory_format=CL)
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
