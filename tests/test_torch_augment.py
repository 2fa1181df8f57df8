"""The port's device augmentation against ``ugpg_tpu/data/augment.py`` and
``ugpg_tpu/ops/rotate.py`` on the CPU.

JAX's random streams cannot be reproduced in torch, so each test replays
the JAX key splits (``augment_monuseg_batch``: split(key, 3); the flips:
split(k1) and two Bernoulli draws; the rotation: uniform (or randint) on
k2; the jitter: split(k3, 5)), draws JAX's parameters and feeds them to
the port's apply functions.  Tolerances: images 1e-5 (float32 on both
sides: cos/sin, the bilinear taps and the HSV round trip in other orders),
masks exact (nearest taps and one-hot shears move whole pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugpg_tpu.data import augment as jax_augment
from ugpg_tpu.ops import rotate as jax_rotate
from ugpg_tpu_torch.data import augment
from ugpg_tpu_torch.ops import rotate

B = 4


def _batch(h=24, w=24, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    images = np.stack([np.stack([0.5 + 0.4 * np.sin(5 * xx + i + c) * np.cos(4 * yy - c)
                                 for c in range(3)], -1) for i in range(B)])
    images = np.clip(images + rng.normal(0, 0.05, images.shape), 0, 1).astype(np.float32)
    masks = (rng.random((B, h, w, 1)) > 0.6).astype(np.float32)
    return images, masks


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _jax_params(key, quantize=0):
    """The parameters ``augment_monuseg_batch(key, ...)`` draws."""
    k1, k2, k3 = jax.random.split(key, 3)
    kh, kv = jax.random.split(k1)
    p = {"do_h": jax.random.bernoulli(kh, 0.5, (B,)), "do_v": jax.random.bernoulli(kv, 0.5, (B,))}
    if quantize:
        p["angle_index"] = jax.random.randint(k2, (B,), 0, quantize)
    else:
        p["angle"] = jax.random.uniform(k2, (B,), minval=-90.0, maxval=90.0)
    kb, kc, ks, kh, kp = jax.random.split(k3, 5)
    for name, k in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
        p[name] = 1.0 + jax.random.uniform(k, (B, 1, 1, 1), minval=-0.2, maxval=0.2)
    p["hue"] = jax.random.uniform(kh, (B, 1, 1), minval=-0.05, maxval=0.05)
    p["apply"] = jax.random.bernoulli(kp, 0.8, (B,))
    return {k: torch.from_numpy(np.array(v).reshape(B)) for k, v in p.items()}


def _assert_images(got, want):
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def _assert_masks(got, want):
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flips_match_jax(seed):
    images, masks = _batch(seed=seed)
    key = jax.random.key(seed)
    wi, wm = jax_augment.random_flips(key, jnp.asarray(images), jnp.asarray(masks))
    kh, kv = jax.random.split(key)
    do_h = torch.from_numpy(np.array(jax.random.bernoulli(kh, 0.5, (B,))))
    do_v = torch.from_numpy(np.array(jax.random.bernoulli(kv, 0.5, (B,))))
    _assert_masks(augment.flip(_nchw(images), do_h, do_v), wi)
    _assert_masks(augment.flip(_nchw(masks), do_h, do_v), wm)


@pytest.mark.parametrize("hw", [(24, 24), (20, 27)])
def test_rotation_matches_jax(hw):
    images, masks = _batch(*hw, seed=3)
    key = jax.random.key(3)
    wi, wm = jax.jit(jax_augment.random_rotate)(key, jnp.asarray(images), jnp.asarray(masks))
    angles = torch.from_numpy(np.array(jax.random.uniform(key, (B,), minval=-90.0, maxval=90.0)))
    _assert_images(augment.rotate(_nchw(images), angles), wi)
    _assert_masks(augment.rotate(_nchw(masks), angles, nearest=True), wm)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_color_jitter_matches_jax(prob):
    images, _ = _batch(seed=4)
    images[0, :4, :4] = 1.0  # ties in the HSV maximum
    images[1, :4, :4] = 0.0
    key = jax.random.key(4)
    want = jax.jit(lambda k, x: jax_augment.color_jitter(k, x, 0.2, 0.2, 0.2, 0.05, prob=prob))(
        key, jnp.asarray(images))
    kb, kc, ks, kh, kp = jax.random.split(key, 5)
    draw = lambda k, lo, hi, shape: torch.from_numpy(  # noqa: E731
        np.array(jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(B))
    apply = (torch.from_numpy(np.array(jax.random.bernoulli(kp, prob, (B,)))) if prob < 1
             else torch.ones(B, dtype=torch.bool))
    got = augment.jitter(_nchw(images), 1 + draw(kb, -0.2, 0.2, (B, 1, 1, 1)),
                         1 + draw(kc, -0.2, 0.2, (B, 1, 1, 1)), 1 + draw(ks, -0.2, 0.2, (B, 1, 1, 1)),
                         draw(kh, -0.05, 0.05, (B, 1, 1)), apply)
    _assert_images(got, want)


@pytest.mark.parametrize("quantize", [0, 8])
@pytest.mark.parametrize("seed", [0, 5])
def test_augment_monuseg_batch_matches_jax(seed, quantize):
    images, masks = _batch(seed=seed)
    key = jax.random.key(seed)
    wi, wm = jax_augment.augment_monuseg_batch(key, jnp.asarray(images), jnp.asarray(masks),
                                               quantize_angles=quantize)
    params = _jax_params(key, quantize)
    gi, gm = augment.apply_monuseg_params(_nchw(images), _nchw(masks), params,
                                          quantize_angles=quantize)
    _assert_images(gi, wi)
    _assert_masks(gm, wm)


@pytest.mark.parametrize("angle,hw", [(-67.5, (24, 24)), (12.0, (18, 26)), (45.0, (24, 24)),
                                      (135.0, (18, 26))])
def test_rotate_fixed_matches_jax(angle, hw):
    images, masks = _batch(*hw, seed=6)
    want = jax.jit(lambda x, m: (jax_rotate.rotate_fixed(x, angle),
                                 jax_rotate.rotate_fixed(m, angle, nearest=True),
                                 jax_rotate.rotate_fixed_gather(x, angle)))(
        jnp.asarray(images), jnp.asarray(masks))
    _assert_images(rotate.rotate_fixed(_nchw(images), angle), want[0])
    _assert_masks(rotate.rotate_fixed(_nchw(masks), angle, nearest=True), want[1])
    _assert_images(rotate.rotate_fixed_gather(_nchw(images), angle), want[2])


def test_random_rotate_quantized_per_sample_choice_matches_jax():
    images, masks = _batch(seed=7)
    key = jax.random.key(7)
    wi, wm = jax_rotate.random_rotate_quantized(key, jnp.asarray(images), jnp.asarray(masks),
                                                n_angles=5)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (B,), 0, 5)))
    _assert_images(rotate.rotate_quantized(_nchw(images), idx, 90.0, 5), wi)
    _assert_masks(rotate.rotate_quantized(_nchw(masks), idx, 90.0, 5, nearest=True), wm)
    assert rotate.angle_grid(90.0, 5) == jax_rotate.angle_grid(90.0, 5)
    with pytest.raises(ValueError, match="n_angles"):
        rotate.angle_grid(90.0, 0)
    g = torch.Generator().manual_seed(0)
    out = rotate.random_rotate_quantized(g, _nchw(images), _nchw(masks), n_angles=5)
    assert out[0].shape == (B, 3, 24, 24) and set(out[1].unique().tolist()) <= {0.0, 1.0}


def test_sampler_marginals():
    g = torch.Generator().manual_seed(0)
    n = 4096
    p = augment.sample_monuseg_params(g, n)
    assert p["angle"].min() >= -90.0 and p["angle"].max() <= 90.0
    assert abs(p["angle"].mean().item()) < 3.0 and p["angle"].std().item() > 45.0
    assert abs(p["apply"].float().mean().item() - 0.8) < 0.025
    for k in ("do_h", "do_v"):
        assert abs(p[k].float().mean().item() - 0.5) < 0.03
    for k in ("brightness", "contrast", "saturation"):
        assert 0.8 <= p[k].min().item() and p[k].max().item() <= 1.2
    assert p["hue"].abs().max().item() <= 0.05
    q = augment.sample_monuseg_params(g, n, quantize_angles=8)
    assert set(q["angle_index"].unique().tolist()) == set(range(8)) and "angle" not in q
    # one generator draw replays exactly
    a = augment.augment_monuseg_batch(torch.Generator().manual_seed(3), *map(_nchw, _batch()))
    b = augment.augment_monuseg_batch(torch.Generator().manual_seed(3), *map(_nchw, _batch()))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
