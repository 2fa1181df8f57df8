"""The port's Herlev data path against the JAX package's, on a tree of BMPs
this file writes with ``struct``: the BMP decoder (bit for bit against
``ugpg_tpu.native.decode_bmp_native``), ``HerlevDataset`` (split lists,
class weights, the binary mapping, the split manifest, images within one
gray level of PIL's bilinear resize), ``create_herlev_splits``, and the
corrupted-image rules."""

import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest

from ugpg_tpu.data import herlev as jax_herlev
from ugpg_tpu.native import decode_bmp_native
from ugpg_tpu_torch import native
from ugpg_tpu_torch.data.herlev import (
    BINARY_MAPPING,
    CLASS_NAMES,
    HerlevDataset,
    create_herlev_splits,
)
from ugpg_tpu_torch.data.monuseg import load_rgb

COUNTS = {name: n for name, n in zip(CLASS_NAMES, (7, 5, 9, 4, 6, 8, 3))}


def bmp_bytes(img: np.ndarray, bits: int = 24, top_down: bool = False) -> bytes:
    """An uncompressed BI_RGB BMP of an (H, W, 3) uint8 image, rows padded
    to 4 bytes; 32-bit files carry an alpha byte."""
    h, w, _ = img.shape
    bpp = bits // 8
    stride = (w * bpp + 3) // 4 * 4
    rows = []
    for y in (range(h) if top_down else range(h - 1, -1, -1)):
        px = img[y, :, ::-1]  # RGB -> BGR
        if bpp == 4:
            px = np.concatenate([px, np.full((w, 1), 255, np.uint8)], 1)
        row = px.astype(np.uint8).tobytes()
        rows.append(row + b"\0" * (stride - len(row)))
    data = b"".join(rows)
    header = struct.pack("<2sIHHI", b"BM", 54 + len(data), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, len(data),
                       2835, 2835, 0, 0)
    return header + info + data


def palette_bmp_bytes(h: int = 4, w: int = 5) -> bytes:
    """An 8-bit palette BMP: outside the decoder's profile."""
    stride = (w + 3) // 4 * 4
    data = bytes(stride * h)
    palette = b"".join(struct.pack("<BBBB", i, i, i, 0) for i in range(256))
    off = 54 + len(palette)
    header = struct.pack("<2sIHHI", b"BM", off + len(data), 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, len(data), 2835, 2835, 256, 0)
    return header + info + palette + data


def cell_image(rng, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    cy, cx, r = h / 2, w / 2, min(h, w) / 3
    img = rng.integers(150, 230, (h, w, 3))
    img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(40, 120, 3)
    return np.clip(img + rng.integers(-10, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def write_herlev_tree(root: Path, seed: int = 0) -> Path:
    """Class folders of BMPs: 24- and 32-bit, bottom-up and top-down, odd
    widths and heights."""
    rng = np.random.default_rng(seed)
    for ci, (name, n) in enumerate(COUNTS.items()):
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = int(rng.integers(20, 60)), int(rng.integers(21, 61)) | 1
            kind = (ci + i) % 3
            (d / f"{name[:4]}_{i:03d}.BMP" if i == 0 else d / f"{name[:4]}_{i:03d}.bmp"
             ).write_bytes(bmp_bytes(cell_image(rng, h, w), bits=32 if kind == 2 else 24,
                                     top_down=kind == 1))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_herlev_tree(tmp_path_factory.mktemp("herlev") / "Herlev")


@pytest.mark.parametrize("bits,top_down,h,w", [(24, False, 7, 5), (24, True, 6, 9),
                                                (32, False, 5, 3), (32, True, 8, 1),
                                                (24, False, 1, 13)])
def test_bmp_decoder_matches_jax_bit_for_bit(tmp_path, bits, top_down, h, w):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / "x.bmp"
    path.write_bytes(bmp_bytes(img, bits, top_down))
    got = native.decode_bmp(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, decode_bmp_native(str(path)))
    np.testing.assert_array_equal(native.decode_bmp(path.read_bytes()), img)
    assert native.image_hw(path) == (h, w)


def test_bmp_outside_the_profile_raises_naming_the_file(tmp_path):
    path = tmp_path / "palette.bmp"
    path.write_bytes(palette_bmp_bytes())
    assert decode_bmp_native(str(path)) is None  # the JAX package hands it to PIL
    with pytest.raises(ValueError, match="palette.bmp.*outside the profile"):
        native.decode_bmp(path)
    path.write_bytes(bmp_bytes(np.zeros((4, 4, 3), np.uint8))[:60])
    with pytest.raises(ValueError, match="truncated"):
        native.decode_bmp(path)


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("binary", [False, True])
def test_split_lists_weights_and_manifest_match_jax(tree, tmp_path, split, binary):
    ours = HerlevDataset(str(tree), image_size=32, split=split, binary_classification=binary,
                         verbose=False)
    ref = jax_herlev.HerlevDataset(str(tree), image_size=32, split=split,
                                   binary_classification=binary, verbose=False)
    assert ours.samples == ref.samples and ours.labels == ref.labels and len(ours) > 0
    np.testing.assert_array_equal(ours.get_class_weights(), ref.get_class_weights())
    a = json.loads(Path(ours.save_split_info(str(tmp_path / "a"))).read_text())
    b = json.loads(Path(ref.save_split_info(str(tmp_path / "b"))).read_text())
    assert a == b


def test_images_match_jax_within_one_gray_level(tree):
    for size in (32, 64):  # most files shrink to 32 px and grow to 64 px
        ours = HerlevDataset(str(tree), image_size=size, split="train", verbose=False)
        ref = jax_herlev.HerlevDataset(str(tree), image_size=size, split="train",
                                       verbose=False)
        for i in range(0, len(ours), 3):
            (a, la), (b, lb) = ours[i], ref[i]
            assert a.shape == b.shape == (size, size, 3) and a.dtype == np.float32
            assert la == lb
            np.testing.assert_allclose(a, b, rtol=0, atol=1 / 255 + 1e-6)
    raw = HerlevDataset(str(tree), split="val", transform=False, verbose=False)
    img, _ = raw[0]
    np.testing.assert_array_equal(img * 255.0, native.decode_bmp(raw.samples[0]).astype(np.float32))


def test_presplit_tree_and_create_herlev_splits_match_jax(tree, tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    create_herlev_splits(str(tree), str(ours))
    jax_herlev.create_herlev_splits(str(tree), str(ref))

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    assert listing(ours) == listing(ref)
    for name in ("train", "val", "test"):
        a = json.loads((ours / f"{name}_split_info.json").read_text())
        b = json.loads((ref / f"{name}_split_info.json").read_text())
        assert a == b
    for split in ("train", "val", "test"):  # the written tree reads back pre-split
        ds = HerlevDataset(str(ours), split=split, verbose=False)
        jds = jax_herlev.HerlevDataset(str(ref), split=split, verbose=False)
        assert [os.path.basename(p) for p in ds.samples] == [os.path.basename(p)
                                                             for p in jds.samples]
        assert ds.labels == jds.labels
    assert BINARY_MAPPING == jax_herlev.BINARY_MAPPING and CLASS_NAMES == jax_herlev.CLASS_NAMES


def test_corrupted_image_rules(tree, tmp_path, capsys):
    root = write_herlev_tree(tmp_path / "H", seed=1)
    ds = HerlevDataset(str(root), image_size=16, split="train", verbose=False)
    bad = Path(ds.samples[0])
    bad.write_bytes(b"not an image")  # readable, but not a BMP: raises naming it
    with pytest.raises(ValueError, match=bad.name):
        ds[0]
    bad.unlink()
    bad.mkdir()  # unreadable: the corrupted-image rule, a black image
    img, label = ds[0]
    assert img.shape == (16, 16, 3) and not img.any() and label == ds.labels[0]
    assert f"Error loading image {bad}" in capsys.readouterr().out
    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"\xff\xd8")  # listed by the dataset, but the port has no JPEG decoder
    with pytest.raises(ValueError, match="x.jpg: no decoder"):
        load_rgb(str(jpg))


def test_missing_structure_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="Cannot find"):
        HerlevDataset(str(tmp_path / "empty"), verbose=False)
