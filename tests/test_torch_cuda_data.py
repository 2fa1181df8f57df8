"""The port's device data path on the card: the prefetch queue and the
MoNuSeg augmentation.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_data.py

Tolerances: prefetched batches exact (a copy); the augmentation on the
card against its CPU run on the same parameters, images 1e-5 (float32
sums in other orders on the two devices), masks exact (the rotation's
matrices are rounded from float64 trig on both, so every nearest tap
lands on the same pixel).
"""

import numpy as np
import pytest
import torch

from ugpg_tpu_torch.data.augment import apply_monuseg_params, sample_monuseg_params
from ugpg_tpu_torch.data.loader import prefetch_to_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the prefetch queue copies to it)")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _batches(n=6):
    rng = np.random.default_rng(0)
    return [(rng.random((4, 64, 64, 3), dtype=np.float32),
             (rng.random((4, 64, 64, 1)) > 0.5).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("side_stream", [False, True])
def test_prefetch_delivers_batches_in_order_on_the_consumer_stream(cuda, side_stream):
    batches = _batches()
    stream = torch.cuda.Stream(cuda) if side_stream else torch.cuda.current_stream(cuda)
    stats = {}
    got = []
    with torch.cuda.stream(stream):
        busy = torch.randn(2048, 2048, device=cuda)
        for images, masks in prefetch_to_device(iter(batches), size=2, device=cuda, stats=stats):
            assert images.device == masks.device == cuda
            busy = busy @ busy.T / 2048  # keep the consumer's stream behind the copies
            got.append((images * 1.0, masks * 1.0))  # used on the consumer's stream
    torch.cuda.synchronize()
    assert stats["batches"] == len(batches) and stats["wait_s"] >= 0
    for (gi, gm), (wi, wm) in zip(got, batches):
        np.testing.assert_array_equal(gi.cpu().numpy(), wi)
        np.testing.assert_array_equal(gm.cpu().numpy(), wm)


def test_prefetch_reraises_a_producer_error_on_the_card(cuda):
    def broken():
        yield _batches(1)[0]
        raise OSError("disk gone")

    it = prefetch_to_device(broken(), device=cuda)
    assert next(it)[0].device == cuda
    with pytest.raises(OSError, match="disk gone"):
        next(it)


@pytest.mark.parametrize("quantize", [0, 8])
def test_augmentation_on_the_card_equals_its_cpu_run(cuda, quantize):
    images, masks = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(cuda)
                     for a in _batches(1)[0])
    g = torch.Generator(device=cuda).manual_seed(quantize)
    params = sample_monuseg_params(g, images.shape[0], quantize_angles=quantize)
    assert all(v.device == cuda for v in params.values())
    gi, gm = apply_monuseg_params(images, masks, params, quantize_angles=quantize)
    ci, cm = apply_monuseg_params(images.cpu(), masks.cpu(),
                                  {k: v.cpu() for k, v in params.items()},
                                  quantize_angles=quantize)
    np.testing.assert_allclose(gi.cpu().numpy(), ci.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gm.cpu().numpy(), cm.numpy())
