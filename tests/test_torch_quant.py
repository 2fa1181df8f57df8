"""The port's W8A8 int8 path (``ugpg_tpu_torch/ops/quant.py``, ``Predictor(quantize=True)``,
``export_model --quantize``) on the CPU, against ``ugpg_tpu.ops.quant`` and the JAX
package's ``Predictor``; cases after ``tests/test_quant.py``.

Weights: seeded JAX variables (``tests/test_torch_models.py::jax_variables`` at width 0.25,
stages 1 and 4; ``tests/test_torch_classifier.py::jax_cls_variables`` at stage 2), BN folded
by JAX and carried across with ``io/from_jax.py``; 32 px, batch 2.  JAX's int8 logits are its
jitted program with the scales closed over, as ``QuantizedModel`` and its ``Predictor`` run it.

Tolerances, measured on an x86-64 CPU (torch 2.13.0+cpu, jax 0.9.0):

* the float32 walker: logits 1e-5 (as ``test_quant.py:40``; measured 1.9e-6), amax rtol 1e-5
  (measured 4.4e-7).  The bf16 walker's scales: rtol 2^-7, one bf16 step at the max
  (measured: equal).
* ``quantize_weights`` given JAX's scales: ``wq`` bit for bit (measured: no tie moved),
  scale and bias rtol 1e-6 (measured: equal).
* ``_conv_i8``: exact, against int64 sums, at 1024 input channels of +-127 (|sum| up to
  1.5e8, past 2^24) and at K = 27 (3 channels, padded to 8).
* The int8 logits against JAX's: 1e-5 (measured 2.4e-7: only the float32 head sums differ
  in order), and every int8 quantization point equal to the same forward through JAX's bf16
  resize (the classifier has no upsample).  The upsample operator
  (``upsample2x_bf16_taps``) rounds as JAX's bf16 resize: bf16 tap weights, float32 sums,
  the H pass rounded to bf16 before the W pass.
* int8 against float: ``test_quant.py:56``'s RMS bound (0.2 x std + 1e-4; 0.25 for the
  classifier, ``:213``) and decisions equal away from 1e-3 of the threshold in 99.9% of
  pixels.
* ``Predictor(quantize=True)``: probabilities 5e-3 and uncertainty 2e-2 from the float
  predictor (``test_quant.py:104-105``), uint8 requests 5e-3 (``:131``), the classifier 0.05
  (``:239``), on flax's initialisation as there (measured 1.5e-4, 3.0e-4 and 9.3e-6).
  Against JAX's int8 ``Predictor`` on the same He-scaled checkpoint and calibration batch:
  segmentation probabilities and uncertainty 1e-5 (measured 6e-8 and 1.2e-7), preds equal
  away from 1e-5 of the threshold (none flipped); classification probabilities 1e-5
  (measured 6e-8), labels equal.
* An int8 artifact answers bit for bit as the live int8 predictor.
"""

import functools
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_models import jax_variables
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.models import classifier as jax_classifier
from ugpg_tpu.models import pgunet as jax_pgunet
from ugpg_tpu.models.folding import fold_batchnorm as jax_fold_batchnorm
from ugpg_tpu.ops import quant as jq
from ugpg_tpu_torch.cli import export_model
from ugpg_tpu_torch.eval.exported import ExportedPredictor
from ugpg_tpu_torch.eval.serving import Predictor
from ugpg_tpu_torch.io.checkpoint import full_classifier_state_dict, save_checkpoint
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models import classifier as port_classifier
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, PGUNet1
from ugpg_tpu_torch.ops import quant as tq
from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.resize import upsample2x_bilinear_align_corners

CPU = dict(device="cpu")
CASES = {"seg1": ("segmentation", 1), "seg4": ("segmentation", 4),
         "cls2": ("classification", 2)}


@functools.lru_cache(maxsize=None)
def case(name: str) -> SimpleNamespace:
    """JAX's folded variables, their port state dict, a batch, JAX's bf16 scales and
    qparams, and JAX's jitted int8 logits on them."""
    task, stage = CASES[name]
    if task == "segmentation":
        variables = jax_variables(stage, width=0.25, seed=10 + stage)
        walker, calibrate, quantize = jq.float_folded_forward, jq.calibrate, jq.quantize_weights
        forward = jq.quantized_forward
    else:
        variables = jax_cls_variables(stage, 7, seed=12)
        walker, calibrate = jq.float_folded_cls_forward, jq.calibrate_cls
        quantize, forward = jq.quantize_cls_weights, jq.quantized_cls_forward
    folded = jax_fold_batchnorm(variables)
    x = np.random.default_rng(stage).random((2, 32, 32, 3), dtype=np.float32)
    scales = calibrate(folded, stage, [x])
    qp = quantize(folded, stage, scales)
    jitted = jax.jit(lambda qp, x: forward(qp, scales, stage, x))  # scales closed over
    return SimpleNamespace(task=task, stage=stage, folded=folded,
                           sd=state_dict_from_jax(folded), x=x, scales=scales, qp=qp,
                           logits=np.asarray(jitted(qp, jnp.asarray(x))),
                           walker=walker)


def _port(c):
    if c.task == "segmentation":
        return tq.float_folded_forward, tq.calibrate, tq.quantize_weights, tq.quantized_forward
    return (tq.float_folded_cls_forward, tq.calibrate_cls, tq.quantize_cls_weights,
            tq.quantized_cls_forward)


def _port_int8(c, points=None):
    _, _, quantize, forward = _port(c)
    return forward(quantize(c.sd, c.stage, c.scales), c.scales, c.stage,
                   torch.from_numpy(c.x), points).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_float_walker_matches_jax(name):
    c = case(name)
    walker, calibrate = _port(c)[:2]
    want, want_amax = c.walker(c.folded, c.stage, jnp.asarray(c.x), dtype=jnp.float32)
    got, got_amax = walker(c.sd, c.stage, torch.from_numpy(c.x), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert set(got_amax) == set(want_amax)
    for k, v in want_amax.items():
        np.testing.assert_allclose(got_amax[k].item(), float(v), rtol=1e-5, err_msg=k)
    # the bf16 calibration that Predictor runs
    scales = calibrate(c.sd, c.stage, [c.x], **CPU)
    assert set(scales) == set(c.scales)
    for k, v in c.scales.items():
        np.testing.assert_allclose(scales[k], v, rtol=2 ** -7, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_quantize_weights_matches_jax(name):
    c = case(name)
    got = _port(c)[2](c.sd, c.stage, c.scales)
    blocks = [b for b in c.qp if not b.startswith("__")]
    assert sorted(b for b in got if not b.startswith("__")) == sorted(blocks)
    for b in blocks:
        for conv in ("conv1", "conv2"):
            g, w = got[b][conv], c.qp[b][conv]
            assert g["wq"].dtype == torch.int8 and int(g["wq"].abs().max()) <= 127
            np.testing.assert_array_equal(g["wq"].numpy(), np.asarray(w["wq"]), err_msg=b)
            for k in ("scale", "bias"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-6)
    head = "__heads__" if c.task == "segmentation" else "__head__"
    for h, leaves in c.qp[head].items():
        for k, v in leaves.items():
            assert got[head][h][k].dtype == torch.float32
            np.testing.assert_array_equal(got[head][h][k].numpy(), np.asarray(v))
    if name == "seg4":
        # up1's conv1 reads [down3 out | upsampled]: two input scales baked into wq
        s_skip, s_up = c.scales["down3.out"], c.scales["up1.up"]
        assert s_skip != s_up
        k = c.sd["up1.conv.conv_op.0.weight"].permute(2, 3, 1, 0)
        deq = got["up1"]["conv1"]["wq"].float() * got["up1"]["conv1"]["scale"]
        half = k.shape[2] // 2
        for sl, s in ((slice(0, half), s_skip), (slice(half, None), s_up)):
            ratio = deq[:, :, sl] / k[:, :, sl]
            big = k[:, :, sl].abs() > 0.5 * k.abs().max()  # away from int8 rounding noise
            np.testing.assert_allclose(ratio[big].numpy(), s, rtol=0.02)


@pytest.mark.parametrize("cin,chunked", [(1024, False), (3, False), (20, True)])
def test_conv_i8_is_exact(cin, chunked, monkeypatch):
    """int32 sums equal int64 ones; 1024 channels of +-127 pass 2^24."""
    rng = np.random.default_rng(cin)
    n, h, w, cout = (2, 4, 4, 8) if not chunked else (5, 6, 6, 16)
    x = rng.choice([-127, 127], (n, h, w, cin)).astype(np.int8)
    k = rng.choice([-127, 127], (3, 3, cin, cout)).astype(np.int8)
    if cin == 1024:
        x[0], k[..., 0] = 127, 127  # one output at the extreme: 127^2 * 9 * 1024
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(xp[:, ky:ky + h, kx:kx + w] @ k[ky, kx].astype(np.int64)
               for ky in range(3) for kx in range(3))
    if chunked:  # a patch cap of two images: three _int_mm calls
        monkeypatch.setattr(tq, "_PATCH_BYTES", 2 * h * w * 9 * 24)
    got = tq._conv_i8(torch.from_numpy(x), tq.weight_matrix(torch.from_numpy(k)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if cin == 1024:
        assert want.max() == 127 ** 2 * 9 * 1024 > 2 ** 24
    np.testing.assert_array_equal(np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(k))), want)


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_forward_matches_jax(name, monkeypatch):
    c = case(name)
    got = _port_int8(c)
    assert got.shape == c.logits.shape and got.dtype == np.float32
    # the upsample operator rounds as JAX's bf16 resize: JAX's program, the classifier
    # (no upsample) included; only the float32 head sums differ in order
    np.testing.assert_allclose(got, c.logits, atol=1e-5, rtol=0)
    if c.task == "segmentation":
        # every int8 point equals the same forward through JAX's bf16 resize
        ours, exact = {}, {}
        _port_int8(c, ours)
        monkeypatch.setattr(library, "upsample2x_bf16_taps", upsample2x_bilinear_align_corners)
        np.testing.assert_allclose(_port_int8(c, exact), c.logits, atol=1e-5, rtol=0)
        assert set(ours) == set(exact) and any(k.endswith(".up") for k in ours)
        for k in ours:
            assert torch.equal(ours[k], exact[k]), k
    # int8 against the float32 walker (test_quant.py:56, :213)
    ref = c.walker(c.folded, c.stage, jnp.asarray(c.x), dtype=jnp.float32)[0]
    ref = np.asarray(ref)
    rms = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rms < (0.2 if c.task == "segmentation" else 0.25) * float(ref.std()) + 1e-4
    if c.task == "segmentation":
        pf, pq = 1 / (1 + np.exp(-ref)), 1 / (1 + np.exp(-got))
        away = np.abs(pf - 0.5) > 1e-3
        assert np.mean(((pf > 0.5) == (pq > 0.5)) | ~away) > 0.999


# ---------------------------------------------------------------- Predictor and artifacts
@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Stage-1 checkpoints for both packages: segmentation at width 0.25 and a 5-class
    classifier, each with seeded He-scaled weights (logits spread around 0) and with
    flax's initialisation as ``test_quant.py`` makes them; calibration images."""
    d = tmp_path_factory.mktemp("quant_ckpts")
    x = jnp.zeros((1, 32, 32, 3))
    seg_init = jax_pgunet.STAGE_MODELS[1](num_classes=1, width=0.25).init(
        jax.random.key(1), x, False)
    cls_init = jax_classifier.HerlevClassificationModel(stage=1, num_classes=5).init(
        jax.random.key(2), x[:, :16, :16], False)
    paths = {}
    for name, v in (("seg", jax_variables(1, width=0.25, seed=21)), ("seg_init", seg_init),
                    ("cls", jax_cls_variables(1, 5, seed=22)), ("cls_init", cls_init)):
        meta = {"stage": 1} if name.startswith("seg") else {"stage": 1,
                                                             "config": {"num_classes": 5}}
        jax_save_checkpoint(d / name, v, metadata=meta)
        sd = state_dict_from_jax(v)
        if name.startswith("cls"):
            sd = full_classifier_state_dict(sd, 1)
        save_checkpoint(d / f"{name}.pth", sd, stage=1, epoch=0)
        paths[name], paths[f"j{name}"] = str(d / f"{name}.pth"), str(d / name)
    cal = np.random.default_rng(23).random((4, 32, 32, 3), dtype=np.float32)
    np.save(d / "cal.npy", cal)
    return SimpleNamespace(**paths, cal=cal, cal_path=str(d / "cal.npy"))


@pytest.fixture
def narrow(monkeypatch):
    """Both packages build stage 1 at width 0.25, the classifier's stage 1 at 16 px."""
    monkeypatch.setitem(STAGE_MODELS, 1, functools.partial(PGUNet1, width=0.25))
    monkeypatch.setitem(jax_pgunet.STAGE_MODELS, 1,
                        functools.partial(jax_pgunet.STAGE_MODELS[1], width=0.25))
    monkeypatch.setitem(port_classifier.CLS_STAGE_RESOLUTIONS, 1, 16)
    monkeypatch.setitem(jax_classifier.CLS_STAGE_RESOLUTIONS, 1, 16)


def _images(n, seed, px=32):
    return np.random.default_rng(seed).random((n, px, px, 3), dtype=np.float32)


def test_predictor_quantize_requires_calibration_and_warns_off128(ckpts, narrow):
    """``test_quant.py:135``: no calibration raises; a segmentation bucket of 32 or more
    off a multiple of 128 warns; latency buckets, multiples of 128 and the classifier
    stay silent."""
    with pytest.raises(ValueError, match="calibration_batches"):
        Predictor(ckpts.seg, buckets=(2,), quantize=True, **CPU)
    with pytest.raises(ValueError, match="calibration_batches"):
        Predictor(ckpts.cls, task_type="classification", num_classes=5, buckets=(2,),
                  quantize=True, **CPU)
    with pytest.warns(UserWarning, match="128"):
        Predictor(ckpts.seg, buckets=(64,), quantize=True, calibration_batches=[ckpts.cal],
                  **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for buckets in ((2,), (1, 8, 128)):
            Predictor(ckpts.seg, buckets=buckets, quantize=True,
                      calibration_batches=[ckpts.cal], **CPU)
        Predictor(ckpts.cls, task_type="classification", num_classes=5, buckets=(64,),
                  quantize=True, calibration_batches=[ckpts.cal], **CPU)


def test_predictor_quantize_roundtrip(ckpts, narrow):
    """int8 against float32 (``test_quant.py:104-105``) and uint8 requests with compact
    outputs (``:131``) on flax's initialisation, as there; then JAX's int8 Predictor on
    the same He-scaled checkpoint and calibration batch."""
    common = dict(buckets=(2, 4), dtype=None, **CPU)
    quant = dict(quantize=True, calibration_batches=[ckpts.cal])
    x = _images(5, 24)
    pq = Predictor(ckpts.seg_init, **quant, **common)
    (preds_f, probs_f, unc_f), (preds_q, probs_q, unc_q) = (
        Predictor(ckpts.seg_init, **common)(x), pq(x))
    assert preds_q.shape == preds_f.shape == (5, 32, 32, 1)
    np.testing.assert_allclose(probs_q, probs_f, atol=5e-3)
    np.testing.assert_allclose(unc_q, unc_f, atol=2e-2)
    raw = (x * 255).astype(np.uint8)
    p8 = Predictor(ckpts.seg_init, input_dtype=np.uint8, compact_output=True, **quant,
                   **common)
    preds8, probs8, unc8 = p8(raw)
    assert preds8.dtype == np.uint8 and probs8.dtype == unc8.dtype == np.float16
    np.testing.assert_allclose(probs8, pq(raw.astype(np.float32) / 255.0)[1], atol=5e-3)

    preds_q, probs_q, unc_q = Predictor(ckpts.seg, **quant, **common)(x)
    assert probs_q.std() > 0.05  # the He-scaled weights spread the probabilities
    jp = JaxPredictor(ckpts.jseg, buckets=(2, 4), dtype=None, **quant)
    w_preds, w_probs, w_unc = (np.asarray(o) for o in jp(x))
    np.testing.assert_allclose(probs_q, w_probs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(unc_q, w_unc, atol=1e-5, rtol=0)
    assert np.all(np.abs(w_probs[preds_q != w_preds] - 0.5) < 1e-5)


def test_predictor_quantize_classification(ckpts, narrow):
    """``test_quant.py:219``, and JAX's int8 classification Predictor."""
    common = dict(task_type="classification", num_classes=5, buckets=(4,), dtype=None)
    x = _images(4, 25, px=16)
    quant = dict(quantize=True, calibration_batches=[x])
    labels_f, probs_f = Predictor(ckpts.cls_init, **common, **CPU)(x)
    labels_q, probs_q = Predictor(ckpts.cls_init, **quant, **common, **CPU)(x)
    assert labels_q.shape == labels_f.shape == (4,) and labels_q.dtype == np.int32
    np.testing.assert_allclose(probs_q, probs_f, atol=0.05)
    labels_q, probs_q = Predictor(ckpts.cls, **quant, **common, **CPU)(x)
    jp = JaxPredictor(ckpts.jcls, **quant, **common)
    w_labels, w_probs = (np.asarray(o) for o in jp(x))
    np.testing.assert_allclose(probs_q, w_probs, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels_q, w_labels)


def test_int8_artifact_is_bit_identical(ckpts, narrow, tmp_path):
    """``export_model --quantize --calibration``: the artifact answers as the live int8
    predictor calibrated on the same images, on requests of 1, 3, 4 and 6 images."""
    out = tmp_path / "int8"
    export_model.main(["--model", ckpts.seg, "--out", str(out), "--buckets", "1", "4",
                       "--quantize", "--calibration", ckpts.cal_path, "--device", "cpu"])
    served = ExportedPredictor(out, **CPU)
    live = Predictor(ckpts.seg, buckets=(1, 4), dtype=None, quantize=True,
                     calibration_batches=[np.load(ckpts.cal_path)], **CPU)
    for n, seed in ((1, 0), (3, 1), (4, 2), (6, 3)):
        x = _images(n, seed)
        for got, want in zip(served(x), live(x)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
