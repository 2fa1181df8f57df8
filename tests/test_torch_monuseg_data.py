"""The port's MoNuSeg host data path against the JAX package's: the C++
decoders, the PIL-free resize, the datasets, the split and the automatic
pos_weight.  PIL writes the test files here; the port never imports it.

Tolerances: decoded pixels exact; dataset images within one gray level
(1/255: the port's antialiased bilinear resize against PIL's BILINEAR);
masks exact (Pillow's fill and PIL's NEAREST index rule, both exact);
pos_weight rtol 1e-12 (the same float64 sums over equal masks).
"""

import shutil

import numpy as np
import pytest
from PIL import Image, ImageDraw

from tests.test_data_monuseg import make_xml, write_monuseg_tree
from ugpg_tpu.data import monuseg as jax_monuseg
from ugpg_tpu.train.aug_trainer import compute_pos_weight as jax_compute_pos_weight
from ugpg_tpu_torch import native
from ugpg_tpu_torch.data import monuseg
from ugpg_tpu_torch.data.loader import DataLoader
from ugpg_tpu_torch.train.aug_trainer import compute_pos_weight

GRAY = 1.0 / 255 + 1e-6


def _nuclei(rng, n, size):
    out = []
    for _ in range(n):
        k = rng.integers(8, 21)
        c = rng.uniform(0, size, 2)
        r = rng.uniform(4, 12)
        a = np.sort(rng.uniform(0, 2 * np.pi, k))
        out.append([(float(c[0] + r * np.cos(t)), float(c[1] + r * np.sin(t))) for t in a])
    return out


def _image(rng, size):
    """Smooth colour fields with nuclei-like blobs: what a resize sees in H&E."""
    yy, xx = np.mgrid[:size, :size] / size
    base = np.stack([0.6 + 0.3 * np.sin(7 * xx + c) * np.cos(5 * yy - c) for c in (0, 1, 2)], -1)
    return np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/images: a 1000 px Deflate TIFF tile of 400 nuclei and a 256 px
    PNG of 30; train/aug: two PNG patches; val: one TIFF."""
    root = tmp_path_factory.mktemp("monuseg")
    rng = np.random.default_rng(0)
    for sub in ("train/images", "train/annots", "train/aug/images", "train/aug/annots",
                "val/images", "val/annots"):
        (root / sub).mkdir(parents=True)
    files = [("train", "tile", 1000, 400, ".tif"), ("train", "patch", 256, 30, ".png"),
             ("train/aug", "p0", 256, 30, ".png"), ("train/aug", "p1", 256, 25, ".png"),
             ("val", "v0", 300, 40, ".tif")]
    for split, stem, size, n, ext in files:
        img = Image.fromarray(_image(rng, size))
        if ext == ".tif":
            img.save(root / split / "images" / f"{stem}{ext}", compression="tiff_adobe_deflate")
        else:
            img.save(root / split / "images" / f"{stem}{ext}")
        (root / split / "annots" / f"{stem}.xml").write_text(make_xml(_nuclei(rng, n, size)))
    return root


# ---------------------------------------------------------------- decoders
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_tiff_decoder_equals_pil(tmp_path, compression, mode):
    rng = np.random.default_rng(1)
    img = Image.fromarray(_image(rng, 67)).convert(mode)
    path = tmp_path / "a.tif"
    img.save(path, compression=compression)
    got = native.decode_tiff(path)
    np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))
    np.testing.assert_array_equal(got, jax_monuseg.load_rgb(str(path)))
    assert native.image_hw(path) == (67, 67)


def test_png_decoder_equals_pil(tmp_path):
    rng = np.random.default_rng(2)
    img = _image(rng, 45)[:, :37]
    path = tmp_path / "a.png"
    Image.fromarray(img).save(path, optimize=True)  # all five row filters
    np.testing.assert_array_equal(native.decode_png(path), img)
    np.testing.assert_array_equal(native.decode_png(path.read_bytes()), img)
    np.testing.assert_array_equal(monuseg.load_rgb(str(path)), jax_monuseg.load_rgb(str(path)))
    assert native.image_hw(path) == (45, 37)


def test_rejected_files_raise_naming_file_and_profile(tmp_path):
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "gray.png")  # color type 0
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a.jpg")
    (tmp_path / "junk.tif").write_bytes(b"II*\x00garbage")
    with pytest.raises(ValueError, match=r"gray\.png.*color type 0.*8-bit RGB"):
        monuseg.load_rgb(str(tmp_path / "gray.png"))
    with pytest.raises(ValueError, match=r"junk\.tif.*classic TIFF"):
        monuseg.load_rgb(str(tmp_path / "junk.tif"))
    with pytest.raises(ValueError, match=r"a\.jpg: no decoder"):
        monuseg.load_rgb(str(tmp_path / "a.jpg"))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-no-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for png_decode.cpp"):
        native.build(("png_decode",))


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize("src", [1000, 256, 37])
@pytest.mark.parametrize("size", [32, 64, 128, 256, 300])
def test_host_resize_against_pil(src, size):
    rng = np.random.default_rng(src + size)
    img = _image(rng, src)
    mask = (rng.random((src, src)) > 0.5).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR))
    got = monuseg.resize_image(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        monuseg.resize_mask(mask, size),
        np.asarray(Image.fromarray(mask).resize((size, size), Image.NEAREST)))


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("size", [32, 64, 128, 256, 300])
def test_dataset_items_equal_jax(tree, size):
    ds = monuseg.MoNuSegDataset(str(tree), image_size=size, split="train")
    want = jax_monuseg.MoNuSegDataset(str(tree), image_size=size, split="train")
    assert ds.image_files == want.image_files == ["patch.png", "tile.tif"]
    for i in range(len(ds)):
        (img, mask), (wimg, wmask) = ds[i], want[i]
        assert img.dtype == mask.dtype == np.float32
        assert img.shape == (size, size, 3) and mask.shape == (size, size, 1)
        np.testing.assert_allclose(img, wimg, rtol=0, atol=GRAY)
        np.testing.assert_array_equal(mask, wmask)
        assert mask.sum() > 0


def test_raw_items_info_and_aug_dataset_equal_jax(tree):
    ds = monuseg.MoNuSegDataset(str(tree), split="train")
    want = jax_monuseg.MoNuSegDataset(str(tree), split="train")
    for i in range(len(ds)):
        for a, b in zip(ds.load_raw(i), want.load_raw(i)):
            np.testing.assert_array_equal(a, b)
        assert ds.get_sample_info(i) == want.get_sample_info(i)
    aug = monuseg.AugMoNuSegDataset(str(tree), image_size=64, augment=True)
    jaug = jax_monuseg.AugMoNuSegDataset(str(tree), image_size=64, augment=True)
    assert aug.augment and aug.image_files == jaug.image_files == ["p0.png", "p1.png"]
    np.testing.assert_array_equal(aug[1][1], jaug[1][1])
    assert not monuseg.MoNuSegDataset(str(tree), split="val").augment


def test_orphans_warn_and_empty_raises(tree, tmp_path, capsys):
    root = write_monuseg_tree(tmp_path / "M", n_train=2, n_val=1, size=32)
    (root / "train" / "annots" / "train_1.xml").unlink()
    ds = monuseg.MoNuSegDataset(str(root), image_size=32)
    assert len(ds) == 1 and "1 images have no matching annotation" in capsys.readouterr().out
    (root / "train" / "annots" / "train_0.xml").unlink()
    with pytest.raises(RuntimeError, match="No image-annotation pairs"):
        monuseg.MoNuSegDataset(str(root), image_size=32)


def test_split_picks_the_same_files(tmp_path):
    for pkg, name in ((monuseg, "port"), (jax_monuseg, "jax")):
        root = write_monuseg_tree(tmp_path / name, n_train=10, n_val=0, size=16)
        shutil.rmtree(root / "val")
        pkg.create_train_val_split(str(root), val_ratio=0.3, seed=42, move=True)
    for sub in ("train/images", "val/images", "val/annots"):
        port = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert port == sorted(p.name for p in (tmp_path / "jax" / sub).iterdir()), sub
    assert len(list((tmp_path / "port" / "val" / "images").iterdir())) == 3


def test_compute_pos_weight_equals_jax(tree):
    for size in (32, 256):
        ds = monuseg.AugMoNuSegDataset(str(tree), image_size=size)
        want = jax_compute_pos_weight(jax_monuseg.AugMoNuSegDataset(str(tree), image_size=size))
        np.testing.assert_allclose(compute_pos_weight(ds), want, rtol=1e-12)
    masks = np.zeros((4, 8, 8, 1), np.float32)
    assert compute_pos_weight([(None, m) for m in masks]) == 1.0  # no positives


def test_loader_batches_equal_jax_order(tree):
    from ugpg_tpu.data.loader import DataLoader as JaxLoader

    ds = monuseg.MoNuSegDataset(str(tree), image_size=32, split="train")
    jds = jax_monuseg.MoNuSegDataset(str(tree), image_size=32, split="train")
    for _ in range(2):  # the shuffle state carries across epochs
        got = list(DataLoader(ds, batch_size=1, shuffle=True, num_workers=2, seed=7))
        want = list(JaxLoader(jds, batch_size=1, shuffle=True, num_workers=2, seed=7))
        assert len(got) == len(want) == 2
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.shape == (1, 32, 32, 3)
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_allclose(gi, wi, atol=GRAY)


def test_pil_drawn_tile_rasterizes_equal(tree):
    """The tile's mask at full size equals a direct ImageDraw fill."""
    ds = monuseg.MoNuSegDataset(str(tree), split="train")
    _, mask = ds.load_raw(1)
    from ugpg_tpu_torch.data.rasterize import parse_polygons

    ref = Image.new("L", (1000, 1000), 0)
    draw = ImageDraw.Draw(ref)
    for p in parse_polygons(tree / "train" / "annots" / "tile.xml"):
        draw.polygon([tuple(map(float, pt)) for pt in p], fill=1)
    np.testing.assert_array_equal(mask, np.asarray(ref))
