"""MoNuSeg XML polygon annotations -> binary masks (counterpart of
``ugpg_tpu/data/rasterize.py``).

* ``parse_polygons``: XML -> a list of (N, 2) float64 (x, y) arrays, every
  ``.//Region`` with three or more ``.//Vertex``.
* ``rasterize_polygons``: polygons -> (H, W) uint8 {0, 1} mask.  The
  default, ``backend="auto"`` (or ``"pil"``), is the port's C++ copy of
  Pillow's polygon fill, bit for bit: the fill of the reference and of the
  JAX package's default, with no Pillow installed.  ``"native"`` is the
  JAX package's even-odd C++ scanline and ``"numpy"`` its numpy scanline;
  both fill fewer boundary pixels than Pillow.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from ugpg_tpu_torch import native

__all__ = ["parse_polygons", "rasterize_polygons", "xml_to_mask", "annotation_info"]

BACKENDS = ("auto", "pil", "native", "numpy")


def parse_polygons(xml_path: str | Path) -> list[np.ndarray]:
    """All polygons with >=3 vertices, each as an (N, 2) float64 array of
    (x, y) coordinates."""
    root = ET.parse(str(xml_path)).getroot()
    polygons = []
    for region in root.findall(".//Region"):
        pts = [(float(v.attrib["X"]), float(v.attrib["Y"])) for v in region.findall(".//Vertex")]
        if len(pts) >= 3:
            polygons.append(np.asarray(pts, dtype=np.float64))
    return polygons


def annotation_info(xml_path: str | Path) -> dict:
    """The nucleus count and the MicronsPerPixel metadata."""
    root = ET.parse(str(xml_path)).getroot()
    return {
        "num_nuclei": len(root.findall(".//Region")),
        "microns_per_pixel": float(root.attrib.get("MicronsPerPixel", 0.252)),
    }


def _fill_polygon_numpy(mask: np.ndarray, poly: np.ndarray) -> None:
    """Even-odd scanline fill at integer rows, spans [ceil(x0), floor(x1)]."""
    h, w = mask.shape
    ys = poly[:, 1]
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    n = len(poly)
    for y in range(y0, y1 + 1):
        yc = y + 0.0
        xs = []
        for i in range(n):
            x_a, y_a = poly[i]
            x_b, y_b = poly[(i + 1) % n]
            if (y_a <= yc < y_b) or (y_b <= yc < y_a):
                t = (yc - y_a) / (y_b - y_a)
                xs.append(x_a + t * (x_b - x_a))
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            a = max(int(np.ceil(xs[j])), 0)
            b = min(int(np.floor(xs[j + 1])), w - 1)
            if b >= a:
                mask[y, a:b + 1] = 1


def rasterize_polygons(polygons: list[np.ndarray], image_hw: tuple[int, int],
                       backend: str = "auto") -> np.ndarray:
    """uint8 {0,1} mask of shape (H, W) with all polygons filled, in order.

    backend: ``"auto"`` and ``"pil"`` (Pillow's fill, bit for bit),
    ``"native"`` (the even-odd C++ scanline) or ``"numpy"``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    h, w = image_hw
    if backend in ("auto", "pil"):
        return native.rasterize_polygons_pil(polygons, (h, w))
    if backend == "native":
        return native.rasterize_polygons_native(polygons, (h, w))
    mask = np.zeros((h, w), dtype=np.uint8)
    for poly in polygons:
        _fill_polygon_numpy(mask, poly)
    return mask


def xml_to_mask(xml_path: str | Path, image_size_wh: tuple[int, int]) -> np.ndarray:
    """Reference-compatible helper: (W, H) in, (H, W) mask out."""
    w, h = image_size_wh
    return rasterize_polygons(parse_polygons(xml_path), (h, w))
