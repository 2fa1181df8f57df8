"""The port's ``DummyDataset`` (``data/synthetic.py``) and ``random_affine``
(``data/augment.py``) against the JAX package's, on the CPU.

``DummyDataset`` draws the same numpy arrays from the same seed.
``random_affine`` draws its parameters from a ``torch.Generator``; the
test draws them again from a generator in the same state and runs JAX's
``affine_sample`` on JAX's ``_affine_matrix`` of those parameters: images
within 1e-5 (float32 cos/sin and bilinear taps in other orders, as
``tests/test_torch_augment.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugpg_tpu.data import augment as jax_augment
from ugpg_tpu.data.synthetic import DummyDataset as JaxDummyDataset
from ugpg_tpu_torch.data import augment
from ugpg_tpu_torch.data.synthetic import DummyDataset

B = 4


@pytest.mark.parametrize("kwargs", [{}, {"num_samples": 3, "image_size": 16, "in_channels": 1,
                                         "seed": 7}])
def test_dummy_dataset_is_jax_s(kwargs):
    ours, want = DummyDataset(**kwargs), JaxDummyDataset(**kwargs)
    assert len(ours) == len(want)
    for i in range(len(want)):
        for got, ref in zip(ours[i], want[i]):
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
    assert set(np.unique(ours.masks)) <= {0.0, 1.0}


@pytest.mark.parametrize("hw,kwargs", [
    ((24, 24), {}),
    ((20, 27), {"max_deg": 15.0, "translate": 0.2, "scale_range": (0.8, 1.2)}),
])
def test_random_affine_is_jax_s_on_the_same_draw(hw, kwargs):
    h, w = hw
    rng = np.random.default_rng(5)
    images = rng.random((B, h, w, 3), dtype=np.float32)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    got = augment.random_affine(g, torch.from_numpy(images).permute(0, 3, 1, 2), **kwargs)

    g.set_state(state)  # the same draws, in random_affine's order
    max_deg = kwargs.get("max_deg", 0.0)
    translate = kwargs.get("translate", 0.1)
    lo, hi = kwargs.get("scale_range", (0.9, 1.1))
    angles = torch.rand(B, generator=g) * (2 * max_deg) - max_deg
    t = (torch.rand((B, 2), generator=g) * (2 * translate) - translate) * torch.tensor(
        [w, h], dtype=torch.float32)
    scales = torch.rand(B, generator=g) * (hi - lo) + lo
    mats = jax.vmap(jax_augment._affine_matrix)(jnp.asarray(angles.numpy()),
                                                jnp.asarray(t.numpy()),
                                                jnp.asarray(scales.numpy()))
    want = jax.vmap(lambda im, m: jax_augment.affine_sample(im, m, "bilinear"))(
        jnp.asarray(images), mats)
    assert got.shape == (B, 3, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not np.allclose(np.asarray(want), images)  # the draw moved the images
