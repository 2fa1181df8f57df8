"""The port's stage-4 Predictor (BN folded and live, called and streamed)
and BatchingServer against the JAX Predictor.

Full-width stage-4 weights come from a numpy seed (non-trivial BN stats),
are saved as a JAX checkpoint and converted with the JAX package's own
``export_torch_checkpoint``; the port serves the ``.pth`` on the CPU, the
JAX package serves the checkpoint.  Three images in bucket 2 give two
device calls, one of them padded.

Tolerances: probabilities and uncertainty 1e-4 (both sides are float32
end to end and differ in summation order only); preds equal except where
a probability lies within 1e-4 of the threshold.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests.test_torch_models import jax_variables
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.io.checkpoint import save_checkpoint
from ugpg_tpu.io.torch_export import export_torch_checkpoint
from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor

MAP_TOL = 1e-4
THRESHOLD = 0.5


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage4")
    save_checkpoint(d / "ckpt", jax_variables(4, width=1.0, seed=4), metadata={"stage": 4})
    export_torch_checkpoint(str(d / "ckpt"), str(d / "model.pth"))
    reference = JaxPredictor(str(d / "ckpt"), dtype=jnp.float32, buckets=(2,))
    port = Predictor(str(d / "model.pth"), dtype=torch.float32, buckets=(2,), device="cpu")
    return d, reference, port


def _images(seed, shape=(3, 256, 256, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _check(got, want, compact=False):
    preds, probs, unc = got
    w_preds, w_probs, w_unc = want
    assert preds.shape == probs.shape == unc.shape == w_probs.shape
    tol = MAP_TOL
    if compact:
        # the compact response is the float32 one stored smaller: uint8
        # preds, float16 maps, which round values in [0, 1] by at most half
        # a float16 step, 2**-12
        assert preds.dtype == np.uint8 and probs.dtype == unc.dtype == np.float16
        tol += 2.0 ** -12
    else:
        assert preds.dtype == probs.dtype == unc.dtype == np.float32
    assert w_probs.std() > 0.05  # the seeded model does separate pixels
    np.testing.assert_allclose(probs.astype(np.float32), w_probs, atol=tol, rtol=0)
    np.testing.assert_allclose(unc.astype(np.float32), w_unc, atol=tol, rtol=0)
    differ = preds.astype(np.float32) != w_preds
    assert np.all(np.abs(w_probs[differ] - THRESHOLD) < MAP_TOL)


def test_predictor_float32_input_matches_jax(served):
    _, reference, port = served
    x = _images(0)
    calls = port.stats()["device_calls"]
    _check(port(x), reference(x))
    assert port.stats()["device_calls"] - calls == 2  # a full and a padded bucket


def test_predictor_uint8_input_matches_jax(served):
    d, reference, _ = served
    port8 = Predictor(str(d / "model.pth"), dtype=torch.float32, buckets=(2,),
                      input_dtype=np.uint8, device="cpu")
    x = np.random.default_rng(1).integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    # the JAX float32 Predictor divides uint8 requests by 255 in float32 on
    # the host, the same arithmetic its uint8 executable runs on the device
    _check(port8(x), reference(x))


def test_predictor_off_size_request_matches_jax(served):
    _, reference, port = served
    x = _images(2, (3, 200, 300, 3))
    _check(port(x), reference(x))


def test_predictor_compact_output_matches_jax(served):
    d, reference, _ = served
    compact = Predictor(str(d / "model.pth"), dtype=torch.float32, buckets=(2,),
                        compact_output=True, device="cpu")
    x = _images(3)
    _check(compact(x), reference(x), compact=True)


def test_batching_server_matches_direct_call(served):
    _, _, port = served
    x = _images(4, (4, 256, 256, 3))
    direct = port(x)
    server = BatchingServer(port, max_latency_ms=200.0)
    try:
        futures = [server.submit(im) for im in x]
        results = [f.result(timeout=120) for f in futures]
    finally:
        server.close()
    for i, outs in enumerate(results):
        for got, want in zip(outs, direct):
            np.testing.assert_allclose(got, want[i], atol=1e-6, rtol=0)
    stats = server.stats()
    assert stats["submitted"] == 4 and stats["groups"] <= 4
    # the stream of the same images, in batches of 2 and 1, gives the same maps
    streamed = list(port.stream(iter([x[:2], x[2:3], x[3:]])))
    assert [o[0].shape[0] for o in streamed] == [2, 1, 1]
    for i, got in enumerate(zip(*streamed)):
        np.testing.assert_allclose(np.concatenate(got), direct[i], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        list(port.stream(iter([x[:3]])))


def test_predictor_live_bn_matches_jax(served):
    """fold_bn=False runs the BN model in plain PyTorch; folding is exact
    algebra, so it meets the (folded) JAX Predictor within the same 1e-4."""
    d, reference, _ = served
    live = Predictor(str(d / "model.pth"), dtype=torch.float32, buckets=(2,), fold_bn=False,
                     device="cpu")
    assert live.model.inc.conv.use_bn and live.model.inc.conv.conv_op[1].running_var.std() > 0
    x = _images(5)
    _check(live(x), reference(x))
