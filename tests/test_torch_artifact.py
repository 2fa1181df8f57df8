"""The port's serving artifacts (``Predictor.export``, ``SlidePredictor.export``,
``eval/exported.py``) on the CPU, against the live port predictors and the
JAX package's exported artifacts.

Weights: seeded JAX variables at full width (stage 1, non-trivial BN stats,
``tests/test_torch_models.py::jax_variables``; a stage-1 Herlev classifier,
``tests/test_torch_classifier.py::jax_cls_variables``), converted for the
port with its own ``io/from_jax.py``.  The tests that compare the port
with itself serve a stage-1 model at width 0.25 (``narrow``: the port's
``STAGE_MODELS[1]`` narrowed for the test), which keeps them fast.

Tolerances: an artifact answers bit for bit as the live port predictor it
was exported from (the same operators and plain torch ops on the same
device); against the JAX package's artifact, probabilities and uncertainty
1e-4 (float32 on both sides, summed in other orders) and preds equal
except where a probability lies within 1e-4 of the threshold.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_models import jax_variables
from ugpg_tpu.eval.exported import ExportedPredictor as JaxExportedPredictor
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu_torch.cli import export_model
from ugpg_tpu_torch.eval.exported import ExportedPredictor
from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor
from ugpg_tpu_torch.eval.slide import ExportedSlidePredictor, SlidePredictor
from ugpg_tpu_torch.io.checkpoint import full_classifier_state_dict, save_checkpoint
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.blocks import init_parameters
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, PGUNet1

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{"seg": (JAX checkpoint dir, .pth), "cls": (JAX dir, .pth)}, stage 1."""
    d = tmp_path_factory.mktemp("artifact_ckpts")
    v = jax_variables(1, width=1.0, seed=31)
    jax_save_checkpoint(d / "seg", v, metadata={"stage": 1})
    save_checkpoint(d / "seg.pth", state_dict_from_jax(v), stage=1, epoch=0)
    vc = jax_cls_variables(1, 7, seed=32)
    jax_save_checkpoint(d / "cls", vc, metadata={"stage": 1, "config": {"num_classes": 7}})
    save_checkpoint(d / "cls.pth", full_classifier_state_dict(state_dict_from_jax(vc), 1),
                    stage=1, epoch=0)
    return {"seg": (str(d / "seg"), str(d / "seg.pth")),
            "cls": (str(d / "cls"), str(d / "cls.pth"))}


@pytest.fixture(scope="module")
def narrow_pth(tmp_path_factory):
    """A seeded stage-1 checkpoint at width 0.25."""
    path = tmp_path_factory.mktemp("artifact_narrow") / "seg_narrow.pth"
    model = PGUNet1(use_bn=True, width=0.25)
    init_parameters(model, torch.Generator().manual_seed(33))
    save_checkpoint(path, model.state_dict(), stage=1, epoch=0)
    return str(path)


@pytest.fixture
def narrow(narrow_pth, monkeypatch):
    """``narrow_pth``, with the port building stage 1 at width 0.25."""
    monkeypatch.setitem(STAGE_MODELS, 1, functools.partial(PGUNet1, width=0.25))
    return narrow_pth


def _images(n, seed, px=32, uint8=False):
    g = np.random.default_rng(seed)
    if uint8:
        return g.integers(0, 256, (n, px, px, 3), dtype=np.uint8)
    return g.random((n, px, px, 3), dtype=np.float32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


FORMS = {"float32": {}, "uint8": dict(input_dtype=np.uint8),
         "compact": dict(input_dtype=np.uint8, compact_output=True)}


@pytest.mark.parametrize("form", list(FORMS))
def test_segmentation_artifact_is_bit_identical(form, narrow, tmp_path):
    """Requests of 1, 3, 4 and 6 images (one bucket, a ragged one, two
    chunks), float32 and uint8 requests, against the live predictor."""
    pth = narrow
    buckets = (1, 4) if form == "float32" else (4,)
    live = Predictor(pth, buckets=buckets, dtype=None, **FORMS[form], **CPU)
    art = live.export(tmp_path / form)
    served = ExportedPredictor(art, **CPU)
    assert sorted(p.name for p in art.iterdir()) == [f"bucket_{b}.pt2" for b in buckets] + [
        "manifest.json"]
    m = served.manifest
    assert m["format_version"] == 1 and m["platforms"] == ["cpu", "cuda"]
    assert (m["task_type"], m["stage"], m["resolution"], m["buckets"], m["n_outputs"]) == (
        "segmentation", 1, 32, list(buckets), 3)
    assert m["input_dtype"] == ("float32" if form == "float32" else "uint8")
    assert m["torch_version"] == torch.__version__
    for n, seed in ((1, 0), (3, 1), (4, 2), (6, 3)):
        for uint8 in (False, True):
            x = _images(n, seed, uint8=uint8)
            _same(served(x), live(x))
    assert served.stats()["device_calls"] == live.stats()["device_calls"] == 10


def test_artifact_matches_jax_exported(ckpts, tmp_path):
    """The manifest has the JAX manifest's keys (torch_version for
    jax_version) and values; the maps agree with JAX's artifact's."""
    jdir, pth = ckpts["seg"]
    port_path = Predictor(pth, buckets=(4,), dtype=None, **CPU).export(tmp_path / "port")
    jax_path = JaxPredictor(jdir, buckets=(4,), dtype=None).export(tmp_path / "jax",
                                                                   platforms=("cpu",))
    port_m = json.loads((port_path / "manifest.json").read_text())
    jax_m = json.loads((Path(jax_path) / "manifest.json").read_text())
    assert set(port_m) == (set(jax_m) - {"jax_version"}) | {"torch_version"}
    for key in ("format_version", "task_type", "stage", "resolution", "buckets",
                "input_dtype", "n_outputs"):
        assert port_m[key] == jax_m[key], key
    x = _images(5, 7)
    preds, probs, unc = ExportedPredictor(port_path, **CPU)(x)
    w_preds, w_probs, w_unc = (np.asarray(o) for o in JaxExportedPredictor(jax_path)(x))
    assert w_probs.std() > 0.05  # the seeded model separates pixels
    np.testing.assert_allclose(probs, w_probs, atol=TOL, rtol=0)
    np.testing.assert_allclose(unc, w_unc, atol=TOL, rtol=0)
    differ = preds != w_preds
    assert np.all(np.abs(w_probs[differ] - 0.5) < TOL)


@pytest.mark.parametrize("mc_dropout", [0, 4])
def test_classification_artifact_is_bit_identical(mc_dropout, ckpts, tmp_path):
    """The plain classifier and MC dropout, whose head masks the export
    bakes in as a live call draws them: the same labels, probabilities and
    variance, on a repeat too.  The plain one also against JAX's live
    classifier on the same weights."""
    jdir, pth = ckpts["cls"]
    live = Predictor(pth, task_type="classification", num_classes=7,
                     buckets=(2, 4) if mc_dropout else (4,), dtype=None, mc_dropout=mc_dropout,
                     **CPU)
    served = ExportedPredictor(live.export(tmp_path / "cls"), **CPU)
    assert served.task_type == "classification" and served._n_outputs == (3 if mc_dropout
                                                                           else 2)
    for n, seed in ((3, 1), (5, 2)):  # one bucket, then a chunk of 4 and one of 1 in 2
        x = _images(n, seed)
        got = served(x)
        _same(got, live(x))
        _same(served(x), got)
    if mc_dropout:
        assert got[2].shape == (5,) and got[2].max() > 0
    else:
        want = JaxPredictor(jdir, task_type="classification", num_classes=7, buckets=(4,),
                            dtype=None)(x)
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=TOL, rtol=0)


def test_slide_artifact(narrow, tmp_path):
    """Exported sizes (32, 40) and (48, 48): a request of an exported size
    answers bit for bit as the live SlidePredictor; a smaller one goes to
    the smallest size that fits, (48, 48), as the live predictor padding
    to multiples of 16 answers; a larger one raises."""
    pth = narrow
    live = SlidePredictor(pth, **CPU)
    art = live.export(tmp_path / "slide", sizes=((48, 48), (32, 40)))
    served = ExportedSlidePredictor(art, **CPU)
    m = served.manifest
    assert (m["format_version"], m["kind"], m["sizes"]) == (2, "slide", [[32, 40], [48, 48]])
    assert sorted(p.name for p in art.glob("*.pt2")) == ["slide_32x40.pt2", "slide_48x48.pt2"]
    for seed, shape in enumerate(((32, 40), (48, 48))):
        x = np.random.default_rng(seed).random((2, *shape, 3), dtype=np.float32)
        _same(served(x), live(x))
    odd = np.random.default_rng(8).random((1, 37, 45, 3), dtype=np.float32)
    _same(served(odd), SlidePredictor(pth, pad_multiple=16, **CPU)(odd))
    assert served.micro_batch is False and served.resolution == "native"
    with pytest.raises(ValueError, match="exceeds every exported size"):
        served(np.zeros((1, 49, 10, 3), np.float32))


def test_exported_predictor_behind_batching_server(narrow, tmp_path):
    pth = narrow
    live = Predictor(pth, buckets=(4,), dtype=None, **CPU)
    served = ExportedPredictor(live.export(tmp_path / "a"), **CPU)
    x = _images(6, 9)
    server = BatchingServer(served, max_latency_ms=50.0)
    try:
        results = [f.result(60) for f in [server.submit(im) for im in x]]
    finally:
        server.close()
    want = live(x)
    for i, outs in enumerate(results):
        for got, w in zip(outs, want):
            np.testing.assert_array_equal(got, w[i])
    assert server.stats()["submitted"] == 6


def test_export_cli_matches_the_float32_predictor(narrow, tmp_path):
    """ugpg-torch-export builds the predictor in the checkpoint's float32."""
    pth = narrow
    export_model.main(["--model", pth, "--out", str(tmp_path / "cli"), "--buckets", "2",
                       "--uint8", "--compact", "--device", "cpu"])
    served = ExportedPredictor(tmp_path / "cli", **CPU)
    x = _images(3, 10, uint8=True)
    live = Predictor(pth, buckets=(2,), dtype=torch.float32, input_dtype=np.uint8,
                     compact_output=True, **CPU)
    _same(served(x), live(x))


def test_predictor_dtype_none_is_float32(narrow):
    """None is the checkpoint's float32 (the JAX command lines pass it),
    set explicitly rather than passed on to the model."""
    pth = narrow
    p = Predictor(pth, buckets=(2,), dtype=None, **CPU)
    assert p.dtype == torch.float32
    assert {t.dtype for t in p.model.parameters()} == {torch.float32}
    x = _images(2, 11)
    _same(p(x), Predictor(pth, buckets=(2,), dtype=torch.float32, **CPU)(x))


def test_exported_module_imports_no_model_code():
    """eval/exported.py loads with the model code, the checkpoint reader
    and eval/serving.py blocked (as the JAX package's exported.py loads
    without flax)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'ugpg_tpu', 'PIL', 'ugpg_tpu_torch.models',\n"
        "             'ugpg_tpu_torch.io.checkpoint', 'ugpg_tpu_torch.eval.serving'):\n"
        "    sys.modules[name] = None\n"
        "from ugpg_tpu_torch.eval.exported import ExportedPredictor\n"
        "import torch\n"
        "assert hasattr(torch.ops.ugpg_torch, 'fused_double_conv')\n"
        "bad = [m for m in sys.modules if m.startswith(('ugpg_tpu_torch.models',\n"
        "       'ugpg_tpu_torch.train', 'ugpg_tpu_torch.data')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


REFUSALS = ["jax-artifact", "format-version", "export-platform", "cli-quantize",
            "cli-platforms-tpu"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals(case, narrow, tmp_path, capsys):
    pth = narrow
    if case == "jax-artifact":
        (tmp_path / "bucket_1.stablehlo").write_bytes(b"\0")
        (tmp_path / "manifest.json").write_text(json.dumps({"format_version": 1}))
        with pytest.raises(ValueError, match="JAX StableHLO artifact"):
            ExportedPredictor(tmp_path, **CPU)
    elif case == "format-version":
        (tmp_path / "manifest.json").write_text(json.dumps({"format_version": 7}))
        with pytest.raises(ValueError, match="unsupported artifact format: 7"):
            ExportedPredictor(tmp_path, **CPU)
    elif case == "export-platform":
        with pytest.raises(ValueError, match="serve on"):
            Predictor(pth, buckets=(1,), dtype=None, **CPU).export(tmp_path, platforms=("tpu",))
    else:
        flag = ["--quantize"] if case == "cli-quantize" else ["--platforms", "cpu", "tpu"]
        with pytest.raises(SystemExit) as info:
            export_model.main(["--model", pth, "--out", str(tmp_path / "x"), "--device", "cpu",
                               *flag])
        err = capsys.readouterr().err
        if case == "cli-quantize":  # int8 needs its calibration images
            assert info.value.code == 2 and "--quantize requires --calibration" in err
        else:
            assert info.value.code == 2 and "not ported" in err and flag[-1] in err
        assert not (tmp_path / "x").exists()


def test_registry_serves_both_artifact_kinds(narrow, tmp_path):
    from ugpg_tpu_torch.eval.serving import ServingRegistry

    pth = narrow
    live = Predictor(pth, buckets=(2,), dtype=None, **CPU)
    slide = SlidePredictor(pth, **CPU)
    reg = ServingRegistry(max_latency_ms=20.0)
    reg.register_artifact("art", live.export(tmp_path / "b"), **CPU)
    reg.register_artifact("slide", slide.export(tmp_path / "s", sizes=((32, 32),)), **CPU)
    assert isinstance(reg.get("art"), ExportedPredictor)
    assert isinstance(reg.get("slide"), ExportedSlidePredictor)
    x = _images(2, 12)
    _same(reg.predict("art", x), live(x))
    one = reg.submit("slide", x[0]).result(60)  # served directly: no micro-batcher
    _same(one, tuple(o[0] for o in slide(x[0][None])))
    assert reg.submit("art", x[1]).result(60)[1].shape == (32, 32, 1)
    with pytest.raises(ValueError, match="already registered"):
        reg.register_artifact("art", tmp_path / "b", **CPU)
    reg.close()
