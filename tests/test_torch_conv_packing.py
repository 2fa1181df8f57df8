"""The double conv's packed weight layout, held on the CPU.

The bfloat16 kernel (``csrc/double_conv.cu``, ``conv3x3_mma_kernel``)
reads its weights as ``pack_conv3x3`` lays them out: (9, Cout, Cpad),
tap-major, Cin zero-padded to the K chunk.  The kernel itself runs only on
the card, so here its plain model, ``conv3x3_packed_reference`` (the same
packed weights, walked in the kernel's K order: channel chunks, then
taps), is held against ``fused_double_conv_reference`` and against the
JAX package's Pallas kernel in interpret mode.

Tolerances: float32 1e-5 (rtol and atol), as the JAX tests use; bfloat16
one bf16 step of the output (2^-7 of its magnitude), with a floor of
2^-7 x max|output| for outputs near zero, where the two float32 sums,
taken in different orders, may round the middle activation or the output
to neighbouring bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugpg_tpu.ops.pallas.double_conv import fused_double_conv as jax_fused_double_conv
from ugpg_tpu_torch.eval.serving import Predictor
from ugpg_tpu_torch.models.blocks import DoubleConv
from ugpg_tpu_torch.ops.cuda.double_conv import (
    F32_MIN_BLOCKS,
    conv3x3_packed_reference,
    conv_chunk,
    f32_blocks,
    f32_plan,
    fused_double_conv,
    fused_double_conv_reference,
    pack_conv3x3,
    pack_double_conv,
)

BF16_STEP = 2.0 ** -7

# (n, h, w, cin, cm, cout, tile_h): Cin 3, 20, 64; Cm and Cout 8, 24, 64; H
# and W that the kernel's 16x16 tiles do not divide.  tile_h is the Pallas
# kernel's, chosen so that it gives an even number of tiles or one image:
# in interpret mode that kernel returns wrong rows in the first tile of
# image 1 when H / tile_h is odd (ROADMAP.md, section C).
CASES = [
    (1, 9, 13, 3, 8, 24, 3),
    (1, 10, 7, 20, 24, 8, 5),
    (2, 6, 10, 64, 64, 64, 3),
    (1, 15, 5, 3, 64, 8, 5),
    (2, 14, 17, 20, 8, 64, 7),
    (2, 10, 6, 64, 24, 24, 5),
]


def _inputs(seed, n, h, w, cin, cm, cout):
    g = np.random.default_rng(seed)
    x = g.standard_normal((n, h, w, cin)).astype(np.float32)
    w1 = (g.standard_normal((3, 3, cin, cm)) * (2 / (9 * cin)) ** 0.5).astype(np.float32)
    b1 = (g.standard_normal((cm,)) * 0.1).astype(np.float32)
    w2 = (g.standard_normal((3, 3, cm, cout)) * (2 / (9 * cm)) ** 0.5).astype(np.float32)
    b2 = (g.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _torch_args(x, w1, b1, w2, b2, dtype):
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    oihw = lambda w: torch.from_numpy(w).permute(3, 2, 0, 1).to(dtype)  # noqa: E731
    return nchw, oihw(w1), torch.from_numpy(b1), oihw(w2), torch.from_numpy(b2)


def _packed_double_conv(x, w1, b1, w2, b2):
    """The bf16 kernel's two launches, in plain torch: conv1 from packed
    weights, the middle activation rounded to x.dtype, conv2."""
    mid = conv3x3_packed_reference(x, pack_conv3x3(w1), b1).to(x.dtype)
    return conv3x3_packed_reference(mid, pack_conv3x3(w2), b2).to(x.dtype)


def _assert_close(got, want, dtype):
    got, want = got.float().numpy(), want.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_STEP,
                                   atol=BF16_STEP * np.abs(want).max())


def test_pack_conv3x3_layout():
    w = torch.arange(5 * 3 * 9, dtype=torch.float32).reshape(5, 3, 3, 3)
    wp = pack_conv3x3(w)
    assert wp.shape == (9, 5, 16) and wp.is_contiguous()
    for o in range(5):
        for c in range(3):
            for dy in range(3):
                for dx in range(3):
                    assert wp[3 * dy + dx, o, c] == w[o, c, dy, dx]
    assert not wp[:, :, 3:].any()  # K padding is zero


@pytest.mark.parametrize("cin,chunk,cpad", [(3, 16, 16), (8, 16, 16), (16, 16, 16),
                                            (20, 32, 32), (64, 32, 64), (1024, 32, 1024)])
def test_conv_chunk_and_padding(cin, chunk, cpad):
    assert conv_chunk(cin) == chunk
    assert pack_conv3x3(torch.zeros(8, cin, 3, 3)).shape == (9, 8, cpad)


def test_pack_double_conv_float32_is_hwio():
    x, w1, b1, w2, b2 = _inputs(0, 1, 4, 4, 20, 24, 8)
    _, tw1, tb1, tw2, tb2 = _torch_args(x, w1, b1, w2, b2, torch.float32)
    w1k, b1k, w2k, b2k = pack_double_conv(tw1, tb1, tw2, tb2)
    np.testing.assert_array_equal(w1k.numpy(), w1)  # the JAX package's HWIO
    np.testing.assert_array_equal(w2k.numpy(), w2)
    assert b1k.dtype == b2k.dtype == torch.float32
    w1b, _, w2b, _ = pack_double_conv(tw1.bfloat16(), tb1, tw2.bfloat16(), tb2)
    assert w1b.shape == (9, 24, 32) and w2b.shape == (9, 8, 32) and w1b.dtype == torch.bfloat16


# (H, Cin, Cm, Cout) of stage 4's nine DoubleConvs at 256 px; native
# evaluation runs them on a 1000 px tile padded to 1008 px (H * 63 / 16)
STAGE4 = [(256, 3, 64, 64), (128, 64, 128, 128), (64, 128, 256, 256), (32, 256, 512, 512),
          (16, 512, 512, 512), (32, 1024, 256, 256), (64, 512, 128, 128), (128, 256, 64, 64),
          (256, 128, 64, 64)]


@pytest.mark.parametrize("n,scale", [(1, 63 / 16), (8, 1)], ids=["native-1008px-batch1",
                                                                 "stage4-256px-batch8"])
@pytest.mark.parametrize("shape", STAGE4, ids=[f"{s[0]}px-{s[1]}-{s[2]}-{s[3]}" for s in STAGE4])
def test_float32_plan_fills_the_card(n, scale, shape):
    # Each float32 conv launch (conv1 into Cm channels, conv2 into Cout) gets
    # about two blocks per SM, or the largest grid the kernel's tile and
    # block widths allow: a grid of 64 blocks for 132 SMs made the fused
    # kernel this replaced slow at 63 px
    h = round(shape[0] * scale)
    for cout in shape[2:]:
        bn = f32_plan(n, h, h, cout)
        blocks = f32_blocks(n, h, h, cout, bn)
        assert bn in (32, 64)
        assert blocks >= min(F32_MIN_BLOCKS, f32_blocks(n, h, h, cout, 32)), (h, cout, bn, blocks)
        assert blocks >= F32_MIN_BLOCKS, (h, cout, bn, blocks)  # every stage-4 shape reaches it
        if f32_blocks(n, h, h, cout, 64) >= F32_MIN_BLOCKS:
            assert bn == 64  # the wider slice, which stages each input tile half as often


def test_float32_plan_picks_32_for_narrow_outputs_and_small_grids():
    assert f32_plan(1, 1008, 1008, 64) == 64
    assert f32_plan(8, 16, 16, 512) == 32  # 128 blocks at 64: 256 at 32
    assert f32_plan(1, 63, 63, 512) == 64  # 32 tiles x 8 slices = 256
    assert f32_plan(4, 256, 256, 24) == 32 and f32_plan(4, 256, 256, 8) == 32
    assert f32_blocks(1, 63, 63, 512, 64) == 256 and f32_blocks(3, 9, 17, 136, 64) == 36


def test_packed_reference_rejects_another_padding():
    w = torch.zeros(8, 20, 3, 3)
    with pytest.raises(ValueError, match="do not fit"):
        conv3x3_packed_reference(torch.zeros(1, 20, 4, 4), pack_conv3x3(w)[:, :, :24], torch.zeros(8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_packed_walk_matches_reference(case, dtype):
    case = case[:6]
    args = _torch_args(*_inputs(sum(case), *case), dtype)
    got = _packed_double_conv(*args)
    assert got.dtype == dtype and got.shape == (case[0], case[5], case[1], case[2])
    _assert_close(got, fused_double_conv_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_packed_walk_matches_pallas(case, dtype):
    case, tile_h = case[:6], case[6]
    args = _inputs(sum(case), *case)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, w1, b1, w2, b2 = args
    want = jax_fused_double_conv(jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1),
                                 jnp.asarray(w2, jdt), jnp.asarray(b2), tile_h=tile_h,
                                 interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).permute(0, 3, 1, 2)
    _assert_close(_packed_double_conv(*_torch_args(*args, dtype)), want, dtype)


def test_double_conv_pack_keeps_the_state_dict():
    block = DoubleConv(20, 24, use_bn=False).to(torch.bfloat16)
    keys = set(block.state_dict())
    assert block.packed_w1 is None
    block.pack()
    assert set(block.state_dict()) == keys  # non-persistent: names and strict loads unchanged
    block.load_state_dict(DoubleConv(20, 24, use_bn=False).to(torch.bfloat16).state_dict())
    block.pack()  # a snapshot: repack after new weights
    assert block.packed_w1.shape == (9, 24, 32) and block.packed_w2.shape == (9, 24, 32)
    assert block.packed_b1.dtype == torch.float32
    x = torch.randn(1, 20, 6, 5).bfloat16()
    c1, c2 = block.conv_op[0], block.conv_op[3]
    packed = (block.packed_w1, block.packed_b1, block.packed_w2, block.packed_b2)
    torch.testing.assert_close(
        fused_double_conv(x, c1.weight, c1.bias, c2.weight, c2.bias, packed=packed),
        fused_double_conv_reference(x, c1.weight, c1.bias, c2.weight, c2.bias), rtol=0, atol=0)


def test_predictor_packs_every_double_conv(tmp_path):
    from ugpg_tpu_torch.io.checkpoint import save_checkpoint
    from ugpg_tpu_torch.models.pgunet import PGUNet1

    torch.manual_seed(0)
    path = tmp_path / "ug_pgunet_stage1_best.pth"
    save_checkpoint(path, PGUNet1(use_bn=True).state_dict(), stage=1, epoch=0)
    p = Predictor(str(path), buckets=(1,), device="cpu")
    blocks = [m for m in p.model.modules() if isinstance(m, DoubleConv)]
    assert len(blocks) == 3 and all(b.packed_w1 is not None for b in blocks)
    for b in blocks:
        assert b.packed_w1.dtype == torch.bfloat16 and b.packed_w1.shape[0] == 9
