"""The port's offline MoNuSeg augmentation (``cli/augment_monuseg.py``), its
Gaussian blur (``native/gaussian_blur.cpp``) and RGB PNG writer, against
the JAX package's pipeline and PIL, on the CPU.

Tolerances: the blur equals Pillow 12.1.0's ``GaussianBlur`` bit for bit;
the PNG writer's files decode to every written pixel; every step that is
numpy arithmetic in both packages (flips, rot90, brightness/contrast,
the elastic and grid warps and their polygons, noise) and the blur are
exact against JAX's, from the same ``np.random.default_rng`` stream.  The
hue/saturation/value step runs JAX's ``jnp`` HSV arithmetic in numpy
float32: at most 1 uint8 level apart, where XLA may round a fused
multiply-add once and numpy twice (measured: 0 levels on 40 images of
256 px, 7.9M values).  ``run_pipeline``: the same file names, the XML
byte for byte, the patches within that one level.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image, ImageFilter

from tests.test_data_monuseg import write_monuseg_tree
from ugpg_tpu.cli import augment_monuseg as jax_aug
from ugpg_tpu_torch import native
from ugpg_tpu_torch.cli import augment_monuseg as aug
from ugpg_tpu_torch.data.monuseg import AugMoNuSegDataset
from ugpg_tpu_torch.io.png import png_bytes, write_png

HSV_LEVELS = 1


@pytest.mark.parametrize("h,w,radius", [
    (1, 1, 1.0), (7, 5, 0.5), (13, 31, 1.5), (37, 45, 0.999), (64, 64, 2.7),
    (9, 200, 11.0), (256, 256, 0.8374), (17, 3, 0.0),
])
def test_gaussian_blur_is_pillow_s(h, w, radius):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius)))
    np.testing.assert_array_equal(native.gaussian_blur(img, radius), want)


def test_gaussian_blur_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        native.gaussian_blur(np.zeros((4, 4), np.uint8), 1.0)
    with pytest.raises(ValueError, match="out of range"):
        native.gaussian_blur(np.zeros((4, 4, 3), np.uint8), -1.0)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 7), (256, 256), (61, 129)])
def test_rgb_png_writer_reads_back(h, w, tmp_path):
    img = np.random.default_rng(h + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.decode_png(png_bytes(img)), img)
    path = write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(native.decode_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)  # PIL reads it too


def _patch(seed, size=64):
    g = np.random.default_rng(seed)
    img = g.integers(0, 256, (size, size, 3), dtype=np.uint8)
    polys = [g.uniform(0, size - 1, (g.integers(3, 9), 2)) for _ in range(4)]
    return img, polys


STEPS = {
    "hflip": lambda m, img, polys, rng: m._hflip(img, polys, img.shape[0]),
    "vflip": lambda m, img, polys, rng: m._vflip(img, polys, img.shape[0]),
    "rot90-1": lambda m, img, polys, rng: m._rot90(img, polys, img.shape[0], 1),
    "rot90-3": lambda m, img, polys, rng: m._rot90(img, polys, img.shape[0], 3),
    "brightness_contrast": lambda m, img, polys, rng: (m._brightness_contrast(img, rng), polys),
    "elastic": lambda m, img, polys, rng: m._elastic(img, polys, img.shape[0], rng),
    "grid_distortion": lambda m, img, polys, rng: m._grid_distortion(img, polys, img.shape[0],
                                                                     rng),
    "blur": lambda m, img, polys, rng: (m._blur(img, rng), polys),
    "noise": lambda m, img, polys, rng: (m._noise(img, rng), polys),
    "hsv_shift": lambda m, img, polys, rng: (m._hsv_shift(img, rng), polys),
}


@pytest.mark.parametrize("step", list(STEPS))
def test_step_matches_jax(step):
    for seed in range(3):
        img, polys = _patch(seed)
        got_img, got_polys = STEPS[step](aug, img, polys, np.random.default_rng(seed + 10))
        want_img, want_polys = STEPS[step](jax_aug, img, polys, np.random.default_rng(seed + 10))
        got_img, want_img = np.asarray(got_img), np.asarray(want_img)
        assert got_img.dtype == want_img.dtype == np.uint8 and got_img.shape == want_img.shape
        if step == "hsv_shift":
            assert np.abs(got_img.astype(int) - want_img).max() <= HSV_LEVELS
        else:
            np.testing.assert_array_equal(got_img, want_img)
        for g, w in zip(got_polys, want_polys, strict=True):
            np.testing.assert_array_equal(g, w)


def test_patches_polygons_and_xml_match_jax():
    img, _ = _patch(5, size=300)
    polys = [np.array([[10.0, 10], [140, 20], [130, 160]]), np.array([[250.0, 250],
                                                                        [299, 260],
                                                                        [270, 299]])]
    got = list(aug.extract_patches(img, polys, patch=128, stride=64))
    want = list(jax_aug.extract_patches(img, polys, patch=128, stride=64))
    assert len(got) == len(want) == 9  # the grid: 3 x 3
    for (gi, gp, go), (wi, wp, wo) in zip(got, want):
        assert go == wo
        np.testing.assert_array_equal(gi, wi)
        assert aug.polygons_to_xml(gp) == jax_aug.polygons_to_xml(wp)


def test_run_pipeline_matches_jax(tmp_path):
    """The same file names, the XML byte for byte, the patches within the
    HSV step's level; then the dataset reads what the port wrote."""
    root = write_monuseg_tree(tmp_path / "jax", n_train=2, n_val=1, size=160)
    shutil.copytree(root, tmp_path / "port")
    kwargs = dict(patch=64, stride=48, variants=2, seed=3)
    n_jax = jax_aug.run_pipeline(str(root), **kwargs)
    n_port = aug.run_pipeline(str(tmp_path / "port"), **kwargs)
    grid = 2 * 3 * 3  # two 160 px tiles, 3 x 3 patches each
    assert n_port == n_jax == grid * (1 + kwargs["variants"])
    names = {}
    for side in ("jax", "port"):
        aug_dir = tmp_path / side / "train" / "aug"
        names[side] = (sorted(os.listdir(aug_dir / "images")),
                       sorted(os.listdir(aug_dir / "annots")))
    assert names["port"] == names["jax"] and len(names["port"][0]) == n_port
    for name in names["port"][0]:
        stem = name[:-4]
        want = np.asarray(Image.open(tmp_path / "jax/train/aug/images" / name).convert("RGB"))
        got = native.decode_png(tmp_path / "port/train/aug/images" / name)
        assert np.abs(got.astype(int) - want).max() <= HSV_LEVELS, name
        assert ((tmp_path / "port/train/aug/annots" / f"{stem}.xml").read_bytes()
                == (tmp_path / "jax/train/aug/annots" / f"{stem}.xml").read_bytes())
    ds = AugMoNuSegDataset(str(tmp_path / "port"), image_size=32)
    image, mask = ds[0]
    assert len(ds) == n_port and image.shape == (32, 32, 3) and mask.shape == (32, 32, 1)


def test_cli_writes_the_patches(tmp_path):
    root = write_monuseg_tree(tmp_path / "M", n_train=1, n_val=1, size=96)
    assert aug.cli(["--data_dir", str(root), "--patch", "64", "--stride", "32",
                    "--variants", "1"]) == 0
    assert len(os.listdir(root / "train" / "aug" / "images")) == 4 * 2
