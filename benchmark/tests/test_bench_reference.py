"""The plain reference agrees with the port at small sizes on the CPU, in
float32: the segmentation stage (live BN and the folded serving path), the
classifier with its MC-dropout head, and the first train steps."""

import json

import numpy as np
import torch

from benchmark import harness
from benchmark.kinds import Checkpoints, scaled_config, uint8_images
from benchmark.reference import models
from conftest import ROOT, WIDTH


def _config(name, **scale):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    return scaled_config(cfg, scale)


def _nchw(images):
    return torch.as_tensor(images).permute(0, 3, 1, 2).float() / 255.0


@torch.no_grad()
def test_segmentation_stage_matches_the_port(small_port):
    from ugpg_tpu_torch.models.pgunet import PGUNet3, PGUNet4

    cfg = _config("pgunet4-monuseg-256", width=WIDTH, resolution=64)
    for spec, port in ((None, PGUNet4), (cfg["train"]["prev"], PGUNet3)):
        sd = Checkpoints.state_dict(cfg, 11, "cpu", spec)
        ref = models.build(cfg, spec)
        ref.load_state_dict(sd)
        model = port(width=WIDTH)
        model.load_state_dict(sd)
        x = _nchw(uint8_images((2, 64, 64, 3), 12, "cpu"))
        np.testing.assert_allclose(model.eval()(x), ref.eval()(x), rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_folded_float32_serving_matches_the_reference(small_port, tmp_path):
    from ugpg_tpu_torch.eval.serving import Predictor

    cfg = _config("pgunet4-monuseg-256", width=WIDTH, resolution=64)
    ckpts = Checkpoints()
    path = ckpts.write("m", cfg, 21, "cpu", 4)
    images = uint8_images((3, 64, 64, 3), 22, "cpu")
    preds, probs, unc = Predictor(str(path), buckets=(4,), dtype=torch.float32,
                                  input_dtype=np.uint8, device="cpu")(images)
    ckpts.close()
    ref = models.build(cfg)
    ref.load_state_dict(Checkpoints.state_dict(cfg, 21, "cpu"))
    want = torch.sigmoid(ref.eval()(_nchw(images))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(probs, want, atol=1e-5)
    np.testing.assert_allclose(unc, models.uncertainty(torch.as_tensor(want)).numpy(), atol=2e-5)
    sure = np.abs(want - 0.5) > 1e-4
    np.testing.assert_array_equal(preds[sure], (want > 0.5)[sure])


@torch.no_grad()
def test_mc_dropout_classifier_matches_the_reference(small_port):
    from ugpg_tpu_torch.eval.serving import Predictor

    cfg = _config("herlev-cls4-224", resolution=32)
    ckpts = Checkpoints()
    path = ckpts.write("c", cfg, 31, "cpu", 4)
    images = uint8_images((3, 32, 32, 3), 32, "cpu")
    p = Predictor(str(path), buckets=(4,), dtype=torch.float32, input_dtype=np.uint8,
                  device="cpu", task_type="classification", num_classes=7, mc_dropout=8)
    labels, probs, var = p(images)
    ckpts.close()
    ref = models.build(cfg)
    ref.load_state_dict(Checkpoints.state_dict(cfg, 31, "cpu"))
    want, want_var = ref.eval().mc_forward(_nchw(images), 8, 0, 4, slice(0, 3))
    np.testing.assert_allclose(probs, want, atol=1e-5)
    np.testing.assert_allclose(var, want_var, atol=1e-6)
    np.testing.assert_array_equal(labels, want.argmax(-1))


def test_first_train_steps_match_the_reference(small_port):
    scale = small_port["seg4-train-b8"]
    r = harness.run("seg4-train-b8", 2**35 + 9, 0.2, False, device="cpu", scale=scale,
                    log=lambda s: None)
    gaps = {k: v["value"] for k, v in r["checks"].items()}
    assert gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-4
    # RMSprop's first step moves each element by about 10 lr whatever its gradient's
    # size, so round-off in a near-zero gradient can flip an element's step: later
    # steps and the BN statistics drift apart by up to a percent
    assert gaps["update_gap"] < 0.05 and gaps["bn_gap"] < 0.01
    assert r["correct"]
