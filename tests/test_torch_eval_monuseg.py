"""The port's MoNuSeg evaluator, inferer and SlidePredictor against the JAX
package's, on the CPU.

Stage-1 and stage-2 weights at full width (the JAX evaluator has no width
option) come from numpy seeds with non-trivial BN stats
(``tests/test_torch_models.py::jax_variables``), are saved as JAX
checkpoints and converted to ``.pth`` with the JAX package's own
``export_torch_checkpoint``.  Both evaluators read the same dataset object
(the port's), so that their inputs are the same bytes.

Tolerances: probability and uncertainty maps and every metric 1e-4 (both
sides are float32 end to end; the port runs BN folded, the JAX package
live, and they sum in other orders, which leaves gaps near 1e-6); preds
equal except where a probability lies within 1e-4 of the threshold;
``binary_eval_metrics`` 1e-6; the inferer's PNGs bit for bit.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from tests.test_data_monuseg import make_xml, write_monuseg_tree
from tests.test_torch_models import jax_variables
from ugpg_tpu.eval.monuseg import MoNuSegEvaluator as JaxEvaluator
from ugpg_tpu.eval.monuseg import MoNuSegInferer as JaxInferer
from ugpg_tpu.eval.slide import SlidePredictor as JaxSlidePredictor
from ugpg_tpu.io.checkpoint import save_checkpoint
from ugpg_tpu.io.torch_export import export_torch_checkpoint
from ugpg_tpu.metrics.segmentation import binary_eval_metrics as jax_binary_eval_metrics
from ugpg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ugpg_tpu_torch import native
from ugpg_tpu_torch.data.monuseg import MoNuSegDataset
from ugpg_tpu_torch.eval.monuseg import MoNuSegEvaluator, MoNuSegInferer
from ugpg_tpu_torch.eval.slide import ExportedSlidePredictor, SlidePredictor
from ugpg_tpu_torch.io.checkpoint import has_checkpoint, sniff_stage
from ugpg_tpu_torch.io.png import png_bytes, write_png
from ugpg_tpu_torch.metrics.segmentation import binary_eval_metrics
from ugpg_tpu_torch.parallel.mesh import make_mesh

TOL = 1e-4


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{stage: (JAX checkpoint dir, .pth)} at full width, stages 1 and 2."""
    d = tmp_path_factory.mktemp("eval_ckpts")
    out = {}
    for stage in (1, 2):
        jdir = save_checkpoint(d / f"stage{stage}", jax_variables(stage, width=1.0, seed=20 + stage),
                               metadata={"stage": stage, "val_dice": 0.5})
        export_torch_checkpoint(str(jdir), str(d / f"stage{stage}.pth"))
        out[stage] = (str(jdir), str(d / f"stage{stage}.pth"))
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """val: two 64 px TIFF tiles and one odd 37 x 45 tile, with polygons."""
    root = write_monuseg_tree(tmp_path_factory.mktemp("M"), n_train=1, n_val=2, size=64)
    rng = np.random.default_rng(5)
    img = (rng.random((37, 45, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(root / "val" / "images" / "val_odd.tif")
    (root / "val" / "annots" / "val_odd.xml").write_text(
        make_xml([[(3, 4), (20, 6), (15, 30)], [(30, 10), (44, 12), (40, 36), (28, 30)]]))
    return root


def _maps_match(got, want, stage_order=("probs", "preds", "unc")):
    got, want = dict(zip(stage_order, got)), dict(zip(stage_order, want))
    assert want["probs"].std() > 0.01  # the seeded model separates pixels
    np.testing.assert_allclose(got["probs"], want["probs"], atol=TOL, rtol=0)
    np.testing.assert_allclose(got["unc"], want["unc"], atol=TOL, rtol=0)
    differ = got["preds"] != want["preds"]
    assert np.all(np.abs(want["probs"][differ] - 0.5) < TOL)


def _metrics_match(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, atol=TOL, rtol=0, err_msg=k)
        else:
            assert got[k] == v, k


def test_binary_eval_metrics_matches_jax():
    rng = np.random.default_rng(0)
    pred = (rng.random((5, 13, 11)) > 0.5).astype(np.float32)
    target = (rng.random((5, 13, 11)) > 0.6).astype(np.float32)
    pred[0] = target[0] = 0  # empty vs empty scores 1 (EPS in the numerators)
    pred[1] = 1
    want = jax_binary_eval_metrics(jnp.asarray(pred), jnp.asarray(target))
    got = binary_eval_metrics(torch.from_numpy(pred), torch.from_numpy(target))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (5,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert float(got["dice"][0]) == 1.0


@pytest.mark.parametrize("stage", [1, 2])
def test_evaluator_matches_jax(stage, ckpts, tree, tmp_path):
    jdir, pth = ckpts[stage]
    jax_ev, ev = JaxEvaluator(jdir), MoNuSegEvaluator(pth, device="cpu")
    assert ev.stage == jax_ev.stage == stage and ev.resolution == jax_ev.resolution
    assert ev.metadata["val_dice"] == 0.5
    ds = MoNuSegDataset(str(tree), image_size=ev.resolution, split="val", augment=False)

    images = np.stack([ds[i][0] for i in range(2)])
    _maps_match(ev.predict_batch(images), jax_ev.predict_batch(images))

    image = (np.random.default_rng(1).random((50, 70, 3)) * 255).astype(np.uint8)
    mask, conf, unc = ev.predict_image(image, return_uncertainty=True)
    w_mask, w_conf, w_unc = jax_ev.predict_image(image, return_uncertainty=True)
    assert mask.shape == (50, 70) and unc.shape == (ev.resolution,) * 2
    assert conf == pytest.approx(w_conf, abs=TOL)
    np.testing.assert_allclose(unc, w_unc, atol=TOL, rtol=0)
    assert (mask != w_mask).mean() < 0.01  # flips only next to the threshold

    _metrics_match(ev.evaluate_dataset(ds, output_file=str(tmp_path / "e.json"), batch_size=2),
                   jax_ev.evaluate_dataset(ds, batch_size=2))
    assert (tmp_path / "e.json").exists()
    # native resolution, the 37 x 45 tile included (padded to 2 ** pools)
    got = ev.evaluate_dataset_native(ds, output_file=str(tmp_path / "n.json"))
    _metrics_match(got, jax_ev.evaluate_dataset_native(ds))
    assert got["native_resolution"] and got["num_samples"] == 3
    # spatially sharded (ported since): H over 2 shards, each tile padded to
    # the grid's divisor, against JAX's mesh on 2 of its CPU devices
    _metrics_match(ev.evaluate_dataset_native(ds, mesh=make_mesh(2, devices=["cpu"] * 2)),
                   jax_ev.evaluate_dataset_native(ds, mesh=jax_make_mesh(n_data=2)))


@pytest.mark.parametrize("stage,pad_multiple", [(1, None), (2, None), (2, 24)])
def test_slide_predictor_matches_jax_at_odd_sizes(stage, pad_multiple, ckpts):
    jdir, pth = ckpts[stage]
    rng = np.random.default_rng(stage)
    x = (rng.random((2, 37, 45, 3)) * 255).astype(np.uint8)
    port = SlidePredictor(pth, pad_multiple=pad_multiple, device="cpu")
    want = JaxSlidePredictor(jdir, pad_multiple=pad_multiple)(x)
    got = port(x)
    assert [g.shape for g in got] == [(2, 37, 45, 1)] * 3
    _maps_match((got[1], got[0], got[2]), (want[1], want[0], want[2]))
    compact = SlidePredictor(pth, pad_multiple=pad_multiple, compact_output=True, max_batch=2,
                             device="cpu")(x)
    assert compact[0].dtype == np.uint8 and compact[1].dtype == np.float16
    assert port.stats()["device_calls"] == 2  # max_batch 1: one slide per call


def test_slide_predictor_shares_the_native_evaluation_forward(ckpts, tree):
    """SlidePredictor and evaluate_dataset_native run one padded forward:
    the slide's preds score exactly the evaluator's metrics."""
    _, pth = ckpts[2]
    ds = MoNuSegDataset(str(tree), image_size=64, split="val", augment=False)
    img, mask = ds.load_raw(2)
    assert img.shape == (37, 45, 3)
    preds = SlidePredictor(pth, device="cpu")(img[None])[0]
    want = binary_eval_metrics(torch.from_numpy(preds[..., 0]),
                               torch.from_numpy(mask.astype(np.float32))[None])
    ev = MoNuSegEvaluator(pth, device="cpu")

    class One:
        def __len__(self):
            return 1

        def load_raw(self, idx):
            return img, mask

    got = ev.evaluate_dataset_native(One())
    for k, v in want.items():
        assert got[f"{k}_mean"] == float(v[0]), k


def test_slide_predictor_options_outside_the_slice_raise(ckpts, tmp_path):
    """mesh, ported since, raises only without a 'data' axis and shards a
    slide that needs no padding as the live predictor answers it; export,
    ported since, writes an artifact that answers as the live predictor,
    here at the odd 37 x 45 size."""
    _, pth = ckpts[1]
    with pytest.raises(ValueError, match="'data' axis"):
        SlidePredictor(pth, mesh=object(), device="cpu")
    live = SlidePredictor(pth, device="cpu")
    x40 = (np.random.default_rng(4).random((1, 40, 48, 3)) * 255).astype(np.uint8)
    sharded = SlidePredictor(pth, mesh=make_mesh(2, devices=["cpu"] * 2), device="cpu")
    for got, want in zip(sharded(x40)[1:], live(x40)[1:]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    art = live.export(tmp_path / "out", sizes=((37, 45),))
    x = (np.random.default_rng(3).random((1, 37, 45, 3)) * 255).astype(np.uint8)
    for got, want in zip(ExportedSlidePredictor(art, device="cpu")(x), live(x)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="num_classes"):
        SlidePredictor(pth, num_classes=2, device="cpu")


def test_inferer_pngs_match_jax_bit_for_bit(ckpts, tree, tmp_path):
    jdir, pth = ckpts[1]
    src = tree / "val" / "images"
    want = JaxInferer(jdir).infer_directory(str(src), str(tmp_path / "jax"))
    got = MoNuSegInferer(pth, device="cpu").infer_directory(str(src), str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == ["val_0.tif", "val_1.tif", "val_odd.tif"]
    for name in got:
        assert got[name] == pytest.approx(want[name], abs=TOL)
        stem = name.rsplit(".", 1)[0]
        for kind, mode in (("mask", "L"), ("vis", "RGB")):
            mine = tmp_path / "port" / f"{stem}_{kind}.png"
            pil = np.asarray(Image.open(tmp_path / "jax" / f"{stem}_{kind}.png"))
            with Image.open(mine) as im:
                assert im.mode == mode
                np.testing.assert_array_equal(np.asarray(im), pil, err_msg=f"{stem}_{kind}")
            decoded = native.decode_png_gray(mine) if kind == "mask" else native.decode_png(mine)
            np.testing.assert_array_equal(decoded, pil)
            if kind == "mask":
                assert set(np.unique(pil)) == {0, 255}  # both classes present


def test_inferer_raises_on_a_jpeg_it_cannot_decode(ckpts, tree, tmp_path):
    """The JAX inferer selects ``.jpg`` tiles too; the port has no JPEG
    decoder, so it names the file and infers nothing, not a shorter dict."""
    _, pth = ckpts[1]
    src = tmp_path / "tiles"
    src.mkdir()
    Image.open(tree / "val" / "images" / "val_0.tif").save(src / "a.tif")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(src / "b.jpg")
    with pytest.raises(ValueError, match=r"b\.jpg"):
        MoNuSegInferer(pth, device="cpu").infer_directory(str(src), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (37, 45, 3), (2, 5, 3)])
def test_png_writer_matches_pil_pixels(shape, tmp_path):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = write_png(tmp_path / "a.png", img)
    with Image.open(path) as im:
        assert im.mode == ("L" if img.ndim == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(im), img)
    decode = native.decode_png_gray if img.ndim == 2 else native.decode_png
    np.testing.assert_array_equal(decode(path), img)


def test_png_writer_and_gray_decoder_reject_what_they_do_not_take(tmp_path):
    with pytest.raises(ValueError, match="gray or"):
        png_bytes(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        png_bytes(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="color type 2.*8-bit gray"):
        native.decode_png_gray(png_bytes(np.zeros((4, 4, 3), np.uint8)))
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "pil_gray.png", optimize=True)
    np.testing.assert_array_equal(native.decode_png_gray(tmp_path / "pil_gray.png"),
                                  np.zeros((8, 8), np.uint8))


def test_checkpoint_helpers(ckpts, tmp_path):
    jdir, pth = ckpts[2]
    assert has_checkpoint(pth) and not has_checkpoint(tmp_path / "missing.pth")
    assert not has_checkpoint(tmp_path)  # a directory without variables.msgpack is none
    assert sniff_stage(pth) == 2
    assert has_checkpoint(jdir) and sniff_stage(jdir) == 2  # the JAX package's directory
    torch.save({"inc.conv.conv_op.0.weight": torch.zeros(1)}, tmp_path / "bare.pth")
    assert sniff_stage(tmp_path / "bare.pth") == 4 and sniff_stage(tmp_path / "bare.pth", 1) == 1
