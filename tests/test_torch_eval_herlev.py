"""The port's Herlev evaluator, evaluation command line and classification
``Predictor`` against the JAX package's, on the CPU.

One stage-2 classifier (numpy-seeded weights, non-trivial BN stats) is
saved as a JAX checkpoint and exported to a reference ``.pth`` with
``ugpg_tpu``'s own exporter; the JAX side reads the first, the port the
second.  Both evaluators score the same dataset object, so that only the
models differ: probabilities to 1e-4 (the port runs BN folded, JAX live
BN), the labels, report, confusion matrix and AUC equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_herlev_data import write_herlev_tree
from ugpg_tpu.eval.herlev import HerlevEvaluator as JaxEvaluator
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.io.torch_export import export_torch_checkpoint
from ugpg_tpu_torch.cli import test_herlev
from ugpg_tpu_torch.data.herlev import HerlevDataset
from ugpg_tpu_torch.eval.herlev import HerlevEvaluator
from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor

STAGE = 2
PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(JAX checkpoint dir, port .pth, Herlev tree root)."""
    d = tmp_path_factory.mktemp("herlev_eval")
    v = jax_cls_variables(STAGE, 7, seed=21)
    jax_dir = d / "herlev_stage2_best"
    jax_save_checkpoint(jax_dir, v, metadata={"stage": STAGE, "epoch": 1,
                                              "config": {"num_classes": 7}})
    pth = d / "herlev_stage2_best.pth"
    export_torch_checkpoint(str(jax_dir), str(pth), task_type="classification")
    return jax_dir, pth, write_herlev_tree(d / "Herlev")


def test_evaluator_matches_jax(ckpt, tmp_path):
    jax_dir, pth, root = ckpt
    dataset = HerlevDataset(str(root), image_size=64, split="train", augment=False,
                            verbose=False)
    ours = HerlevEvaluator(str(pth), device="cpu")
    ref = JaxEvaluator(str(jax_dir))
    assert ours.stage == ref.stage == STAGE and ours.class_names == ref.class_names
    images = np.stack([dataset[i][0] for i in range(6)])
    np.testing.assert_allclose(ours.predict_probs(images), ref.predict_probs(images),
                               rtol=0, atol=PROB_TOL)
    got = ours.evaluate_dataset(dataset, batch_size=8, output_dir=str(tmp_path / "out"))
    want = ref.evaluate_dataset(dataset, batch_size=8)
    assert got == want and got["num_samples"] == len(dataset) > 8
    assert 0.0 <= got["roc_auc"] <= 1.0
    assert json.loads((tmp_path / "out" / "evaluation_results.json").read_text()) == got
    for name in ("confusion_matrix.png", "class_metrics.png"):  # drawn as JAX's (matplotlib)
        assert (tmp_path / "out" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    for path, drawn in (
            (tmp_path / "cm.png", ours.plot_confusion_matrix(np.zeros((7, 7)), tmp_path / "cm.png")),
            (tmp_path / "m.png", ours.plot_class_metrics(got["classification_report"],
                                                         tmp_path / "m.png")),
            (tmp_path / "s.png", ours.plot_sample_predictions(dataset, tmp_path / "s.png"))):
        assert drawn == path and path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", path


def test_test_command_and_predict(ckpt, tmp_path, capsys):
    _, pth, root = ckpt
    out = tmp_path / "res"
    assert test_herlev.cli(["--model", str(pth), "--data_dir", str(root), "--device", "cpu",
                            "--output_dir", str(out), "--split", "val"]) == 0
    results = json.loads((out / "evaluation_results.json").read_text())
    assert results["stage"] == STAGE and np.isfinite(results["accuracy"])
    assert (out / "sample_predictions.png").is_file()  # the JAX command's grid
    image = HerlevDataset(str(root), split="val", verbose=False).samples[0]
    capsys.readouterr()
    assert test_herlev.cli(["--model", str(pth), "--data_dir", str(root), "--device", "cpu",
                            "--predict", image]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith(image)]
    assert len(lines) == 1 and "(class " in lines[0]


@pytest.mark.parametrize("fold_bn", [True, False])
def test_predictor_matches_jax(ckpt, fold_bn):
    jax_dir, pth, _ = ckpt
    rng = np.random.default_rng(22)
    images = rng.random((11, 80, 72, 3)).astype(np.float32)  # resized to 64 px
    ref = JaxPredictor(str(jax_dir), task_type="classification", num_classes=7,
                       dtype=jnp.float32, buckets=(1, 8))
    ours = Predictor(str(pth), task_type="classification", num_classes=7, dtype=torch.float32,
                     buckets=(1, 8), fold_bn=fold_bn, device="cpu")
    assert ours.resolution == ref.resolution == 64
    for n in (1, 5, 11):
        labels, probs = ours(images[:n])
        want_labels, want_probs = (np.asarray(a) for a in ref(images[:n]))
        assert labels.dtype == np.int32 and probs.dtype == np.float32
        assert labels.shape == (n,) and probs.shape == (n, 7)
        np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROB_TOL)
        np.testing.assert_array_equal(labels, want_labels)
    u8 = np.random.default_rng(24).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    p8 = Predictor(str(pth), task_type="classification", num_classes=7, dtype=torch.float32,
                   buckets=(1, 8), input_dtype=np.uint8, fold_bn=fold_bn, device="cpu")
    np.testing.assert_allclose(p8(u8)[1], ours(u8.astype(np.float32) / 255.0)[1], atol=1e-6)
    server = BatchingServer(ours, max_latency_ms=20.0)
    try:
        futures = [server.submit(im) for im in images[:4]]
        results = [f.result(timeout=120) for f in futures]
    finally:
        server.close()
    direct = ours(images[:4])
    for i, (label, probs) in enumerate(results):
        assert label == direct[0][i]
        np.testing.assert_allclose(probs, direct[1][i], atol=1e-6)


def test_predictor_mc_dropout(ckpt):
    _, pth, _ = ckpt
    images = np.random.default_rng(23).random((5, 64, 64, 3)).astype(np.float32)
    p = Predictor(str(pth), task_type="classification", num_classes=7, dtype=torch.float32,
                  buckets=(1, 8), mc_dropout=4, device="cpu")
    labels, mean, var = p(images)
    assert labels.shape == (5,) and mean.shape == (5, 7) and var.shape == (5,)
    assert (var >= 0).all() and var.max() > 0
    np.testing.assert_array_equal(labels, mean.argmax(-1))
    np.testing.assert_allclose(mean.sum(-1), 1.0, atol=1e-5)
    again = p(images)  # the masks come from mc_seed at every call
    for a, b in zip(again, (labels, mean, var)):
        np.testing.assert_array_equal(a, b)
    p.model.dropout_rates = (0.0, 0.0, 0.0)
    labels0, mean0, var0 = p(images)
    assert not var0.any()
    plain = Predictor(str(pth), task_type="classification", num_classes=7, dtype=torch.float32,
                      buckets=(1, 8), device="cpu")
    np.testing.assert_allclose(mean0, plain(images)[1], atol=1e-6)


@pytest.mark.parametrize("kwargs,error", [
    (dict(task_type="classification", compact_output=True), ValueError),
    (dict(task_type="classification", mc_dropout=1), ValueError),
    (dict(mc_dropout=4), ValueError),  # segmentation has no dropout
    (dict(task_type="classification", mc_dropout=4, quantize=True), ValueError),
    (dict(task_type="classification", quantize=True, mesh=object()), ValueError),  # no 'data'
    (dict(task_type="classification", quantize=True), ValueError),  # no calibration
])
def test_predictor_refusals(ckpt, kwargs, error):
    with pytest.raises(error):
        Predictor(str(ckpt[1]), num_classes=7, device="cpu", **kwargs)
