"""The operation counts and bounds of ``benchmark/counts`` from the
configuration files, against the shape table and the figures of the
port's kernel table."""

import json

import pytest

from benchmark import counts
from conftest import ROOT


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


# chip_smoke.py's DOUBLE_CONVS: (H, Cin, Cm, Cout) of stage 4's DoubleConvs at full width
STAGE4_DOUBLE_CONVS = {
    "inc": (256, 3, 64, 64), "down1": (128, 64, 128, 128), "down2": (64, 128, 256, 256),
    "down3": (32, 256, 512, 512), "down4": (16, 512, 512, 512), "up1": (32, 1024, 256, 256),
    "up2": (64, 512, 128, 128), "up3": (128, 256, 64, 64), "up4": (256, 128, 64, 64),
}


def test_stage4_shapes_are_the_kernel_tables():
    cfg = _config("pgunet4-monuseg-256")
    got = {name: tuple(shape) for name, *shape in counts.double_convs(cfg["blocks"], 256)}
    assert got == {k: tuple(v) for k, v in STAGE4_DOUBLE_CONVS.items()}
    assert counts.head_sides(cfg["blocks"], 256) == [32, 64, 128, 256]


def test_segmentation_forward_is_61_85_gflop():
    assert counts.model_flops(_config("pgunet4-monuseg-256")) / 1e9 == pytest.approx(61.85, abs=0.01)


def test_classifier_encoder_is_20_5_gflop():
    cfg = _config("herlev-cls4-224")
    assert counts.model_flops(cfg) / 1e9 == pytest.approx(20.5, abs=0.05)
    head = 2 * (512 * 512 + 512 * 256 + 256 * 7)
    assert counts.model_flops(cfg, passes=8) - counts.model_flops(cfg) == 7 * head


def test_train_step_counts_three_forwards_and_the_frozen_stage():
    cfg = _config("pgunet4-monuseg-256")
    prev = counts.segmentation_flops(cfg["train"]["prev"]["blocks"],
                                     cfg["train"]["prev"]["heads"], 128, 1)
    assert prev / 1e9 == pytest.approx(39.98, abs=0.01)
    assert counts.train_flops(cfg) == pytest.approx(3 * counts.model_flops(cfg) + prev)


def test_bucket_64_double_conv_bound_is_the_tables_4_001_ms():
    cfg = _config("pgunet4-monuseg-256")
    assert counts.double_conv_bound_s(cfg, 64, "bf16") * 1e3 == pytest.approx(4.001, abs=1e-3)
    assert counts.double_conv_launches(cfg) == 18
    cls = _config("herlev-cls4-224")
    assert counts.double_conv_bound_s(cls, 64, "bf16") * 1e3 == pytest.approx(1.328, abs=1e-3)
    assert counts.double_conv_launches(cls) == 8
