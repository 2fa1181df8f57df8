"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the only path a
CPU tensor takes), and that version is held against the Pallas kernel run
the way the JAX tests run it here: in interpret mode.  Tolerance 1e-5
(rtol and atol), as the JAX tests use: both sides compute in float32.
The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugpg_tpu.ops.pallas import resize2x
from ugpg_tpu.ops.pallas.double_conv import fused_double_conv as jax_fused_double_conv
from ugpg_tpu.ops.pallas.uncertainty_fused import uncertainty_from_logits as jax_uncertainty
from ugpg_tpu.ops.resize import upsample2x_bilinear_align_corners as jax_upsample2x
from ugpg_tpu_torch.ops.cuda.double_conv import fused_double_conv
from ugpg_tpu_torch.ops.cuda.resize2x import upsample2x
from ugpg_tpu_torch.ops.cuda.uncertainty import uncertainty_from_logits

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(4, 32, 32, 1), (1, 7, 13, 1), (3, 33, 65, 2)])
def test_uncertainty_from_logits_matches_pallas(shape):
    # odd sizes do not tile into the Pallas kernel's (256, 128) blocks
    x = (np.random.default_rng(0).standard_normal(shape) * 3).astype(np.float32)
    want = np.asarray(jax_uncertainty(jnp.asarray(x)))  # interpret mode off-TPU
    got = uncertainty_from_logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_binary_uncertainty_matches_jax_and_the_logits_kernel():
    from ugpg_tpu.uncertainty import binary_uncertainty as jax_binary_uncertainty
    from ugpg_tpu_torch.uncertainty import binary_uncertainty

    x = (np.random.default_rng(5).standard_normal((2, 1, 9, 11)) * 3).astype(np.float32)
    p = torch.sigmoid(torch.from_numpy(x))
    got = binary_uncertainty(p).numpy()
    want = np.asarray(jax_binary_uncertainty(jnp.asarray(p.numpy())))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, uncertainty_from_logits(torch.from_numpy(x)).numpy(), **TOL)


def test_uncertainty_from_logits_keeps_dtype_and_layout():
    x = torch.randn(2, 3, 5, 7).to(memory_format=torch.channels_last)
    out = uncertainty_from_logits(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert uncertainty_from_logits(x).is_contiguous(memory_format=torch.channels_last)


def _pallas_interpret():
    call = resize2x.pl.pallas_call
    return mock.patch.object(resize2x.pl, "pallas_call", functools.partial(
        getattr(call, "__wrapped__", call), interpret=True))


@pytest.mark.parametrize("h,c", [(8, 16), (16, 8), (32, 4)])
def test_upsample2x_matches_pallas(h, c):
    x = np.random.default_rng(h).standard_normal((2, h, h, c)).astype(np.float32)
    with _pallas_interpret():
        want = np.asarray(resize2x.upsample2x_pallas(jnp.asarray(x)))
    got = upsample2x(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 1, 5, 3), (1, 4, 1, 2), (1, 1, 1, 1), (2, 3, 7, 5)])
def test_upsample2x_edge_sizes_match_jax(shape):
    # H or W = 1: every output row (column) copies the single input row
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_upsample2x(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(upsample2x(_nchw(x))), want, **TOL)


def _xla_double_conv(x, w1, b1, w2, b2):
    dn = ("NHWC", "HWIO", "NHWC")
    y = jax.lax.conv_general_dilated(x, w1, (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn)
    mid = jnp.maximum(y + b1, 0)
    y2 = jax.lax.conv_general_dilated(mid, w2, (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn)
    return jnp.maximum(y2 + b2, 0)


def _dc_inputs(seed, n, h, w, cin, cm, cout):
    g = np.random.default_rng(seed)
    x = g.standard_normal((n, h, w, cin)).astype(np.float32)
    w1 = (g.standard_normal((3, 3, cin, cm)) * 0.1).astype(np.float32)
    b1 = (g.standard_normal((cm,)) * 0.1).astype(np.float32)
    w2 = (g.standard_normal((3, 3, cm, cout)) * 0.1).astype(np.float32)
    b2 = (g.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _port_double_conv(x, w1, b1, w2, b2):
    oihw = lambda w: torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # noqa: E731
    out = fused_double_conv(_nchw(x), oihw(w1), torch.from_numpy(b1), oihw(w2),
                            torch.from_numpy(b2))
    return _nhwc(out)


@pytest.mark.parametrize("n,h,w,cin,cm,cout,th", [
    (1, 8, 16, 3, 4, 4, 8),       # one tile
    (2, 16, 16, 5, 8, 6, 8),      # first and last tiles only
    (2, 32, 16, 8, 8, 8, 8),      # interior tiles
    (1, 48, 24, 4, 6, 5, 16),     # rectangular, non-128 channels
])
def test_fused_double_conv_matches_pallas(n, h, w, cin, cm, cout, th):
    args = _dc_inputs(h, n, h, w, cin, cm, cout)
    want = np.asarray(jax_fused_double_conv(*map(jnp.asarray, args), tile_h=th, interpret=True))
    np.testing.assert_allclose(_port_double_conv(*args), want, **TOL)


def test_fused_double_conv_ragged_matches_xla():
    # H and W that no tile divides: the port masks the edge instead of
    # rejecting the shape as the TPU kernel does
    args = _dc_inputs(7, 2, 13, 11, 3, 8, 16)
    want = np.asarray(_xla_double_conv(*map(jnp.asarray, args)))
    np.testing.assert_allclose(_port_double_conv(*args), want, **TOL)


def test_fused_double_conv_bf16_matches_pallas():
    # bf16 inputs, float32 sums, the middle activation rounded to bf16 on
    # both sides; a rounding that lands one bf16 step apart would move an
    # output by at most 2e-2 of its scale, hence the bound (none does here)
    args = _dc_inputs(3, 2, 16, 16, 5, 8, 8)
    bf = jnp.bfloat16
    x, w1, b1, w2, b2 = args
    want = jax_fused_double_conv(jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(b1),
                                 jnp.asarray(w2, bf), jnp.asarray(b2), tile_h=8, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got = fused_double_conv(_nchw(x).bfloat16(), t(w1).permute(3, 2, 0, 1), torch.from_numpy(b1),
                            t(w2).permute(3, 2, 0, 1), torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float()), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_wrappers_refuse_devices_without_a_kernel():
    # a tensor that is neither on the CPU nor on a CUDA device never falls
    # back to the plain version
    x = torch.empty(1, 8, 4, 4, device="meta")
    w = torch.empty(8, 8, 3, 3, device="meta")
    b = torch.empty(8, device="meta")
    for call in (lambda: uncertainty_from_logits(x), lambda: upsample2x(x),
                 lambda: fused_double_conv(x, w, b, w, b)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
