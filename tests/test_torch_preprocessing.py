"""The port's MoNuSeg analysis and quality checks (``data/preprocessing.py``)
against the JAX package's, on the CPU.

``analyze_dataset`` and ``check_data_integrity`` return the JAX package's
dictionaries exactly (the same polygons, the same Pillow-exact fill; the
port reads a file with its own decoders where JAX asks PIL, which agree on
a valid tree and on a truncated file).  The two plotting helpers draw
PNGs with matplotlib, as the JAX package's.
"""

import numpy as np
import pytest

from tests.test_data_monuseg import make_xml, write_monuseg_tree
from ugpg_tpu.data.monuseg import MoNuSegDataset as JaxDataset
from ugpg_tpu.data.preprocessing import analyze_dataset as jax_analyze
from ugpg_tpu.data.preprocessing import check_data_integrity as jax_integrity
from ugpg_tpu_torch.data import preprocessing
from ugpg_tpu_torch.data.monuseg import MoNuSegDataset
from ugpg_tpu_torch.io.png import write_png


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = write_monuseg_tree(tmp_path_factory.mktemp("pre") / "M", n_train=3, n_val=2,
                              size=48)
    rng = np.random.default_rng(1)
    polys = [[(5, 5), (30, 8), (20, 40)], [(2, 30), (12, 30), (12, 44), (2, 44)]]
    write_png(root / "train" / "images" / "extra.png",
              rng.integers(0, 256, (40, 52, 3), dtype=np.uint8))
    (root / "train" / "annots" / "extra.xml").write_text(make_xml(polys))
    return root


@pytest.mark.parametrize("split,max_samples", [("train", None), ("train", 2), ("val", None)])
def test_analyze_dataset_is_jax_s(split, max_samples, root):
    ours = preprocessing.analyze_dataset(MoNuSegDataset(str(root), image_size=32, split=split),
                                         max_samples=max_samples)
    want = jax_analyze(JaxDataset(str(root), image_size=32, split=split),
                       max_samples=max_samples)
    assert ours == want
    assert ours["num_samples"] == (max_samples or (4 if split == "train" else 2))


@pytest.mark.parametrize("case", ["valid", "unpaired", "truncated", "missing-split"])
def test_check_data_integrity_is_jax_s(case, root, tmp_path):
    import shutil

    tree = tmp_path / "M"
    shutil.copytree(root, tree)
    splits = ("train", "val")
    if case == "unpaired":
        (tree / "val" / "annots" / "val_1.xml").unlink()
        (tree / "train" / "annots" / "orphan.xml").write_text(make_xml([[(1, 1), (4, 1),
                                                                           (4, 4)]]))
    elif case == "truncated":
        path = tree / "train" / "images" / "train_0.tif"
        path.write_bytes(path.read_bytes()[:100])
        bad = tree / "train" / "images" / "extra.png"
        bad.write_bytes(bad.read_bytes()[:60])
    elif case == "missing-split":
        splits = ("train", "test")
    ours = preprocessing.check_data_integrity(str(tree), splits=splits)
    assert ours == jax_integrity(str(tree), splits=splits)
    assert ours["ok"] == (case == "valid")
    if case == "truncated":
        assert ours["splits"]["train"]["unreadable"] == ["extra.png", "train_0.tif"]


def test_plots_draw_nothing(root, tmp_path):
    """The two plots draw as JAX's where matplotlib is installed (byte for
    byte in ``tests/test_torch_plots.py``); the report returns the
    statistics."""
    ds = MoNuSegDataset(str(root), image_size=32, split="val")
    assert preprocessing.visualize_samples(ds, [0], str(tmp_path / "v.png")) == str(
        tmp_path / "v.png")
    stats = preprocessing.create_data_quality_report(ds, str(tmp_path / "r.png"))
    assert stats == preprocessing.analyze_dataset(ds)
    for name in ("v.png", "r.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
