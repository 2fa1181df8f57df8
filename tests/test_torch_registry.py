"""The port's ``ServingRegistry`` on the CPU: the registry cases of the JAX
package's ``tests/test_serving.py`` (several models, duplicate names,
unknown names, micro-batched submits, close, unregister and replace), and
the retry of a submit whose server closed under it.

Weights: seeded stage-1 segmentation (width 0.25, the port's
``STAGE_MODELS[1]`` narrowed for these tests) and Herlev classifier
checkpoints written by the port (``init_parameters`` from a seed).  The
registry's answers are its predictors' own: compared bit for bit with a
direct call on the same bucket.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor, ServingRegistry
from ugpg_tpu_torch.io.checkpoint import full_classifier_state_dict, save_checkpoint
from ugpg_tpu_torch.models.blocks import init_parameters
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, PGUNet1

CPU = dict(device="cpu", dtype=None)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("registry")
    seg = PGUNet1(use_bn=True, width=0.25)
    init_parameters(seg, torch.Generator().manual_seed(0))
    save_checkpoint(d / "seg.pth", seg.state_dict(), stage=1, epoch=0)
    cls = HerlevClassificationModel(1, 5)
    init_parameters(cls, torch.Generator().manual_seed(1))
    save_checkpoint(d / "cls.pth", full_classifier_state_dict(cls.state_dict(), 1),
                    stage=1, epoch=0)
    return str(d / "seg.pth"), str(d / "cls.pth")


@pytest.fixture(autouse=True)
def narrow_stage1(monkeypatch):
    monkeypatch.setitem(STAGE_MODELS, 1, functools.partial(PGUNet1, width=0.25))


def _images(n, seed):
    return np.random.default_rng(seed).random((n, 32, 32, 3), dtype=np.float32)


def test_serving_registry_multi_model(ckpts):
    seg, cls = ckpts
    reg = ServingRegistry(max_latency_ms=30.0)
    reg.register("seg", seg, buckets=(4,), **CPU)
    reg.register("cls", cls, task_type="classification", num_classes=5, buckets=(4,), **CPU)
    assert reg.names() == ["cls", "seg"]
    with pytest.raises(ValueError, match="already registered"):
        reg.register("seg", seg, **CPU)
    with pytest.raises(KeyError, match="unknown model"):
        reg.get("nope")

    x = _images(3, 0)
    preds, probs, unc = reg.predict("seg", x)
    assert preds.shape == (3, 32, 32, 1)
    labels, cprobs = reg.predict("cls", x)
    assert labels.shape == (3,) and cprobs.shape == (3, 5)

    # micro-batched single requests against both models at once
    futs = [reg.submit("seg", x[0]), reg.submit("cls", x[1]), reg.submit("seg", x[2])]
    assert futs[0].result(30)[0].shape == (32, 32, 1)
    assert futs[1].result(30)[1].shape == (5,)
    np.testing.assert_array_equal(futs[2].result(30)[1], probs[2])  # bucket 4 both ways
    reg.close()
    # predictors stay usable after close; a new submit makes a new server
    reg.predict("seg", x)
    assert reg.submit("seg", x[0]).result(30)[0].shape == (32, 32, 1)
    stats = reg.stats()
    assert set(stats) == {"cls", "seg"} and stats["seg"]["batcher"]["submitted"] == 1
    assert stats["seg"]["predictor"]["requests"] >= 3
    reg.close()


def test_serving_registry_unregister_and_replace(ckpts):
    """Unregister frees the name (draining its batcher); replace swaps the
    predictor, built before the old one goes."""
    seg, _ = ckpts
    reg = ServingRegistry(max_latency_ms=30.0)
    reg.register("m", seg, buckets=(4,), **CPU)
    x = _images(2, 1)
    assert reg.submit("m", x[0]).result(30)[0].shape == (32, 32, 1)

    reg.unregister("m")
    assert reg.names() == []
    with pytest.raises(KeyError, match="unknown model"):
        reg.predict("m", x)
    with pytest.raises(KeyError, match="unknown model"):
        reg.unregister("m")
    reg.register("m", seg, buckets=(4,), **CPU)  # the name is free again
    old = reg.get("m")

    new = reg.replace("m", seg, buckets=(2,), **CPU)
    assert reg.get("m") is new and new is not old and new.buckets == (2,)
    assert reg.predict("m", x)[0].shape == (2, 32, 32, 1)
    with pytest.raises(KeyError, match="unknown model"):
        reg.replace("ghost", seg, **CPU)
    reg.close()


def test_registry_serves_slides_without_the_micro_batcher(ckpts):
    seg, _ = ckpts
    reg = ServingRegistry()
    slide = reg.register_slide("slide", seg, device="cpu")
    x = _images(1, 2)[:, :30, :26]  # any size
    out = reg.submit("slide", x[0]).result(30)
    assert out[1].shape == (30, 26, 1)
    np.testing.assert_array_equal(out[1], slide(x)[1][0])
    assert reg.stats()["slide"].keys() == {"predictor"}  # no batcher was made
    reg.close()


def test_submit_retries_when_its_server_closes_under_it(ckpts, monkeypatch):
    """A server closed between the lookup and the submit is replaced and
    the request sent again, once."""
    seg, _ = ckpts
    reg = ServingRegistry(max_latency_ms=5.0)
    reg.register("m", seg, buckets=(1,), **CPU)
    reg.submit("m", _images(1, 3)[0]).result(30)
    first = reg._servers["m"]
    first.close()  # closed, still in the registry's table
    out = reg.submit("m", _images(1, 3)[0]).result(30)
    assert out[0].shape == (32, 32, 1) and reg._servers["m"] is not first

    calls = []

    def always_closed(self, image):
        calls.append(1)
        raise RuntimeError("server is closed")

    monkeypatch.setattr(BatchingServer, "submit", always_closed)
    with pytest.raises(RuntimeError, match="closing repeatedly"):
        reg.submit("m", _images(1, 3)[0])
    assert len(calls) == 2
    reg.close()


def test_registration_builds_outside_the_lock(ckpts, monkeypatch):
    """While one model loads, the registry answers for the others."""
    seg, _ = ckpts
    reg = ServingRegistry()
    reg.register("a", seg, buckets=(1,), **CPU)
    started, release = threading.Event(), threading.Event()
    real_init = Predictor.__init__

    def slow_init(self, *args, **kwargs):
        started.set()
        release.wait(30)
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(Predictor, "__init__", slow_init)
    t = threading.Thread(target=reg.register, args=("b", seg), kwargs=dict(buckets=(1,), **CPU))
    t.start()
    assert started.wait(30)
    assert reg.submit("a", _images(1, 4)[0]).result(30)[0].shape == (32, 32, 1)
    assert reg.names() == ["a"]
    release.set()
    t.join(60)
    assert not t.is_alive() and reg.names() == ["a", "b"]
    reg.close()
