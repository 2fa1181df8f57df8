"""MoNuSeg analysis and quality checks (counterpart of
``ugpg_tpu/data/preprocessing.py``).

``analyze_dataset`` gives nuclei counts and areas and mask coverage over a
dataset's annotations; ``check_data_integrity`` checks a tree's layout,
image/annotation pairing and readability.  Readability is what the port
can read: its own decoders (``native.decode_png``, ``native.decode_tiff``)
and XML parser, where the JAX package asks PIL's ``Image.verify``; a file
outside a decoder's profile (a 16-bit or palette PNG, a tiled TIFF) is
listed as unreadable here, as training would fail on it.

``visualize_samples`` (image, mask and overlay panels) and
``create_data_quality_report`` (the six-panel report; it returns
``analyze_dataset``'s statistics) are the JAX package's, drawn with
matplotlib where it is installed (imported inside each function, the Agg
backend); without it they draw nothing and return None, as the JAX
package's do.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ugpg_tpu_torch import native
from ugpg_tpu_torch.data.rasterize import parse_polygons, rasterize_polygons

__all__ = [
    "analyze_dataset",
    "visualize_samples",
    "create_data_quality_report",
    "check_data_integrity",
]

_DECODERS = {".png": native.decode_png, ".tif": native.decode_tiff, ".tiff": native.decode_tiff}


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))


def analyze_dataset(dataset, max_samples: int | None = None) -> dict:
    """Nuclei counts and areas, and mask coverage, over the first
    ``max_samples`` samples of a ``MoNuSegDataset``."""
    counts, areas, coverages = [], [], []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        _, annot_path = dataset.samples[i]
        polys = parse_polygons(annot_path)
        counts.append(len(polys))
        areas.extend(_polygon_area(p) for p in polys)
        w, h = dataset.get_sample_info(i)["original_size"]
        mask = rasterize_polygons(polys, (h, w))
        coverages.append(float(mask.mean()))
    areas = np.asarray(areas) if areas else np.zeros(1)
    counts_a = np.asarray(counts) if counts else np.zeros(1)
    return {
        "num_samples": n,
        "nuclei_per_image": {
            "mean": float(counts_a.mean()),
            "std": float(counts_a.std()),
            "min": int(counts_a.min()),
            "max": int(counts_a.max()),
        },
        "nucleus_area_px": {
            "mean": float(areas.mean()),
            "std": float(areas.std()),
            "min": float(areas.min()),
            "max": float(areas.max()),
        },
        "mask_coverage": {
            "mean": float(np.mean(coverages)) if coverages else 0.0,
            "std": float(np.std(coverages)) if coverages else 0.0,
        },
        "counts": counts,
        "coverages": coverages,
    }


def visualize_samples(dataset, indices, output_path: str):
    """Image / mask / overlay panels of ``dataset.load_raw(i)`` for each
    index -> ``output_path``; None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    rows = len(indices)
    fig, axes = plt.subplots(rows, 3, figsize=(12, 4 * rows))
    axes = np.atleast_2d(axes)
    for r, idx in enumerate(indices):
        image, mask = dataset.load_raw(idx)
        axes[r, 0].imshow(image)
        axes[r, 0].set_title(f"Image {idx}")
        axes[r, 1].imshow(mask, cmap="gray")
        axes[r, 1].set_title("Mask")
        axes[r, 2].imshow(image)
        axes[r, 2].imshow(mask, alpha=0.4, cmap="Reds")
        axes[r, 2].set_title("Overlay")
        for c in range(3):
            axes[r, c].axis("off")
    fig.tight_layout()
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return output_path


def create_data_quality_report(dataset, output_path: str, max_samples=None):
    """The six-panel quality report (nuclei per image, mask coverage, a
    summary, three sample overlays) -> ``output_path``; returns
    ``analyze_dataset``'s statistics, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    stats = analyze_dataset(dataset, max_samples=max_samples)
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))

    axes[0, 0].hist(stats["counts"], bins=20, color="tab:blue")
    axes[0, 0].set_title("Nuclei per image")
    axes[0, 1].hist(stats["coverages"], bins=20, color="tab:green")
    axes[0, 1].set_title("Mask coverage fraction")
    axes[0, 2].axis("off")
    lines = [
        f"samples: {stats['num_samples']}",
        f"nuclei/img: {stats['nuclei_per_image']['mean']:.1f} "
        f"± {stats['nuclei_per_image']['std']:.1f}",
        f"area(px): {stats['nucleus_area_px']['mean']:.1f} "
        f"± {stats['nucleus_area_px']['std']:.1f}",
        f"coverage: {stats['mask_coverage']['mean']:.3f}",
    ]
    axes[0, 2].text(0.05, 0.7, "\n".join(lines), fontsize=12, family="monospace")
    axes[0, 2].set_title("Summary")

    # sample overlays in the bottom row
    n_show = min(3, len(dataset))
    for c in range(3):
        ax = axes[1, c]
        if c < n_show:
            image, mask = dataset.load_raw(c)
            ax.imshow(image)
            ax.imshow(mask, alpha=0.4, cmap="Reds")
            ax.set_title(f"Sample {c}")
        ax.axis("off")
    fig.tight_layout()
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return stats


def check_data_integrity(data_dir: str, splits=("train", "val")) -> dict:
    """Layout, pairing and readability of ``{split}/{images,annots}`` for
    each split: the JAX package's report, readability by the port's own
    decoders."""
    report: dict = {"data_dir": data_dir, "splits": {}, "ok": True}
    for split in splits:
        images_dir = os.path.join(data_dir, split, "images")
        annots_dir = os.path.join(data_dir, split, "annots")
        entry = {
            "images_dir_exists": os.path.isdir(images_dir),
            "annots_dir_exists": os.path.isdir(annots_dir),
            "num_images": 0,
            "num_annotations": 0,
            "unpaired_images": [],
            "unpaired_annotations": [],
            "unreadable": [],
        }
        if entry["images_dir_exists"] and entry["annots_dir_exists"]:
            imgs = {f.rsplit(".", 1)[0] for f in os.listdir(images_dir)
                    if f.lower().endswith(tuple(_DECODERS))}
            annots = {f.rsplit(".", 1)[0] for f in os.listdir(annots_dir)
                      if f.lower().endswith(".xml")}
            entry["num_images"] = len(imgs)
            entry["num_annotations"] = len(annots)
            entry["unpaired_images"] = sorted(imgs - annots)
            entry["unpaired_annotations"] = sorted(annots - imgs)
            for stem in sorted(imgs & annots):
                for ext, decode in _DECODERS.items():
                    p = os.path.join(images_dir, stem + ext)
                    if os.path.exists(p):
                        try:
                            decode(p)
                        except (OSError, ValueError):
                            entry["unreadable"].append(stem + ext)
                        break
                try:
                    parse_polygons(os.path.join(annots_dir, stem + ".xml"))
                except Exception:
                    entry["unreadable"].append(stem + ".xml")
        if not entry["images_dir_exists"] or entry["unpaired_images"] or entry["unreadable"]:
            report["ok"] = False
        report["splits"][split] = entry
    return report
