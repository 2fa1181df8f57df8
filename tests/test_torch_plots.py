"""The port's plots (``eval/herlev.py``'s ``plot_*``,
``data/preprocessing.py``'s ``visualize_samples`` and
``create_data_quality_report``) against the JAX package's, on the CPU.

Each plot is drawn from equal inputs by both packages (the same confusion
matrix and report, the same dataset object and its numpy images, the same
classifier weights: a JAX checkpoint and the port's export of it), and the
PNG files are equal byte for byte: matplotlib's Agg backend writes the
same bytes for the same figure.  ``evaluate_dataset(output_dir=)`` and
the ``test_herlev`` command write the JAX package's files.  With
matplotlib made unimportable, each returns None and writes nothing.
"""

import sys

import numpy as np
import pytest

from tests.test_data_monuseg import write_monuseg_tree
from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_herlev_data import write_herlev_tree
from ugpg_tpu.cli import test_herlev as jax_test_herlev
from ugpg_tpu.data import preprocessing as jax_preprocessing
from ugpg_tpu.data.monuseg import MoNuSegDataset as JaxDataset
from ugpg_tpu.eval.herlev import HerlevEvaluator as JaxEvaluator
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu_torch.cli import test_herlev
from ugpg_tpu_torch.data import preprocessing
from ugpg_tpu_torch.data.herlev import HerlevDataset
from ugpg_tpu_torch.data.monuseg import MoNuSegDataset
from ugpg_tpu_torch.eval.herlev import HerlevEvaluator
from ugpg_tpu_torch.io.torch_export import export_torch_checkpoint

STAGE = 2
PLOTS = ("confusion_matrix.png", "class_metrics.png")


@pytest.fixture(scope="module")
def herlev(tmp_path_factory):
    """(JAX evaluator, port evaluator, dataset, JAX checkpoint, .pth, tree)."""
    d = tmp_path_factory.mktemp("plots_herlev")
    jax_dir = d / "herlev_stage2_best"
    jax_save_checkpoint(jax_dir, jax_cls_variables(STAGE, 7, seed=23),
                        metadata={"stage": STAGE, "epoch": 1, "config": {"num_classes": 7}})
    pth = d / "herlev_stage2_best.pth"
    export_torch_checkpoint(jax_dir, pth, task_type="classification")
    root = write_herlev_tree(d / "Herlev")
    dataset = HerlevDataset(str(root), image_size=64, split="train", augment=False,
                            verbose=False)
    return (JaxEvaluator(str(jax_dir)), HerlevEvaluator(str(pth), device="cpu"), dataset,
            jax_dir, pth, root)


@pytest.fixture(scope="module")
def monuseg(tmp_path_factory):
    root = write_monuseg_tree(tmp_path_factory.mktemp("plots_monuseg") / "M", n_train=2,
                              n_val=4, size=48)
    return root, MoNuSegDataset(str(root), image_size=32, split="val")


def _drawn(fn, path):
    """``fn(path)`` -> the PNG's bytes; the function returns the path."""
    assert fn(path) == path
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return data


@pytest.mark.parametrize("plot", ["confusion_matrix", "class_metrics", "sample_predictions"])
def test_herlev_plots_are_jax_s(plot, herlev, tmp_path):
    jax_ev, ev, dataset = herlev[:3]
    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 7, 40), rng.integers(0, 7, 40)
    from ugpg_tpu_torch.metrics.classification import classification_report, confusion_matrix

    if plot == "confusion_matrix":
        cm = confusion_matrix(y_true, y_pred, 7)
        args = (cm,)
    elif plot == "class_metrics":
        args = (classification_report(y_true, y_pred, 7, ev.class_names),)
    else:
        args = (dataset,)
    kwargs = {"num_samples": 6} if plot == "sample_predictions" else {}
    ours = _drawn(lambda p: getattr(ev, f"plot_{plot}")(*args, p, **kwargs), tmp_path / "o.png")
    want = _drawn(lambda p: getattr(jax_ev, f"plot_{plot}")(*args, p, **kwargs),
                  tmp_path / "j.png")
    assert ours == want


def test_evaluate_dataset_and_test_command_write_jax_s_files(herlev, tmp_path):
    jax_ev, ev, dataset, jax_dir, pth, root = herlev
    got = ev.evaluate_dataset(dataset, batch_size=8, output_dir=str(tmp_path / "o"))
    want = jax_ev.evaluate_dataset(dataset, batch_size=8, output_dir=str(tmp_path / "j"))
    assert got == want
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(["evaluation_results.json", *PLOTS])
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == names
    for name in names:
        assert (tmp_path / "o" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name

    assert test_herlev.cli(["--model", str(pth), "--data_dir", str(root), "--device", "cpu",
                            "--split", "val", "--num_samples", "4",
                            "--output_dir", str(tmp_path / "cli_o")]) == 0
    jax_test_herlev.main(["--model", str(jax_dir), "--data_dir", str(root), "--split", "val",
                          "--num_samples", "4", "--output_dir", str(tmp_path / "cli_j")])
    names = sorted(p.name for p in (tmp_path / "cli_j").iterdir())
    assert "sample_predictions.png" in names
    assert sorted(p.name for p in (tmp_path / "cli_o").iterdir()) == names


def test_monuseg_plots_are_jax_s(monuseg, tmp_path):
    root, ds = monuseg
    ours = _drawn(lambda p: preprocessing.visualize_samples(ds, [0, 2], p), tmp_path / "v.png")
    want = _drawn(lambda p: jax_preprocessing.visualize_samples(ds, [0, 2], p),
                  tmp_path / "vj.png")
    assert ours == want
    stats = preprocessing.create_data_quality_report(ds, tmp_path / "r.png", max_samples=3)
    jax_stats = jax_preprocessing.create_data_quality_report(ds, tmp_path / "rj.png",
                                                             max_samples=3)
    assert stats == jax_stats == jax_preprocessing.analyze_dataset(
        JaxDataset(str(root), image_size=32, split="val"), max_samples=3)
    assert stats["num_samples"] == 3
    assert (tmp_path / "r.png").read_bytes() == (tmp_path / "rj.png").read_bytes()


def test_without_matplotlib_every_plot_returns_none(herlev, monuseg, tmp_path, monkeypatch):
    _, ev, dataset = herlev[:3]
    _, ds = monuseg
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any import of it raises ImportError
    assert ev.plot_confusion_matrix(np.eye(7, dtype=np.int64), tmp_path / "cm.png") is None
    assert ev.plot_class_metrics({}, tmp_path / "m.png") is None
    assert ev.plot_sample_predictions(dataset, tmp_path / "s.png") is None
    assert preprocessing.visualize_samples(ds, [0], str(tmp_path / "v.png")) is None
    assert preprocessing.create_data_quality_report(ds, str(tmp_path / "r.png")) is None
    assert not list(tmp_path.iterdir())
    ev.evaluate_dataset(dataset, batch_size=8, output_dir=str(tmp_path / "o"))
    assert [p.name for p in (tmp_path / "o").iterdir()] == ["evaluation_results.json"]
