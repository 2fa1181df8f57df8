"""The port's serving on a device mesh, on the CPU: ``Predictor(mesh=,
shard_model=)`` for both tasks (float32, int8, MC dropout), ``stream``,
``BatchingServer``, ``export``, ``ServingRegistry``, ``SlidePredictor(mesh=,
w_axis=)``, ``evaluate_dataset_native(mesh=, w_axis=, dtype=)`` and the
``serve`` and ``test_monuseg`` command lines with ``--mesh``.

Against the JAX package: its mesh predictors and evaluator on the fake CPU
devices of ``tests/conftest.py``, from seeded full-width stage-1 variables
(``tests/test_torch_models.py::jax_variables``, and
``tests/test_torch_classifier.py::jax_cls_variables``) carried over with
``io/from_jax.py``.  The port's mesh names the CPU at every position, or,
where every data row must serve its own replica (as on distinct cards),
``torch.device("cpu", i)``: torch keys them apart, so the predictor copies
and places its model per row as it does per card.
Port against port: a seeded stage-1 checkpoint at width 0.25 (``narrow``:
the port's ``STAGE_MODELS[1]`` narrowed, as ``tests/test_torch_artifact.py``
does).

Tolerances: against JAX, maps and probabilities 1e-4 (float32 both sides,
BN folded against live, other orders of sums), decisions equal away from
1e-4 of the threshold; against the unsharded port, data-parallel 1e-6 (the
same kernels on fewer rows), tensor-parallel 1e-5 (column slices sum as
the whole) and every int8 point equal.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_data_monuseg import write_monuseg_tree
from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_models import jax_variables
from ugpg_tpu.eval.monuseg import MoNuSegEvaluator as JaxEvaluator
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.eval.slide import SlidePredictor as JaxSlidePredictor
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.models import pgunet as jax_pgunet
from ugpg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ugpg_tpu_torch.cli import serve as serve_cli
from ugpg_tpu_torch.cli import test_monuseg as test_monuseg_cli
from ugpg_tpu_torch.eval import http_server
from ugpg_tpu_torch.eval.exported import ExportedPredictor
from ugpg_tpu_torch.eval.monuseg import MoNuSegEvaluator
from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor, ServingRegistry
from ugpg_tpu_torch.eval.slide import SlidePredictor
from ugpg_tpu_torch.io.checkpoint import full_classifier_state_dict, save_checkpoint
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.blocks import init_parameters
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, PGUNet1
from ugpg_tpu_torch.parallel import tensor
from ugpg_tpu_torch.parallel.mesh import Mesh, make_mesh

CPU = torch.device("cpu")
TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_data, n_model=1):
    return make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{"seg": (JAX dir, .pth), "cls": (JAX dir, .pth)}: stage 1, full width."""
    d = tmp_path_factory.mktemp("mesh_ckpts")
    v = jax_variables(1, width=1.0, seed=41)
    jax_save_checkpoint(d / "seg", v, metadata={"stage": 1})
    save_checkpoint(d / "seg.pth", state_dict_from_jax(v), stage=1, epoch=0)
    vc = jax_cls_variables(1, 7, seed=42)
    jax_save_checkpoint(d / "cls", vc, metadata={"stage": 1, "config": {"num_classes": 7}})
    save_checkpoint(d / "cls.pth", full_classifier_state_dict(state_dict_from_jax(vc), 1),
                    stage=1, epoch=0)
    return {"seg": (str(d / "seg"), str(d / "seg.pth")),
            "cls": (str(d / "cls"), str(d / "cls.pth"))}


@pytest.fixture(scope="module")
def narrow_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_narrow") / "seg_narrow.pth"
    model = PGUNet1(use_bn=True, width=0.25)
    init_parameters(model, torch.Generator().manual_seed(43))
    save_checkpoint(path, model.state_dict(), stage=1, epoch=0)
    return str(path)


@pytest.fixture
def narrow(narrow_pth, monkeypatch):
    """``narrow_pth``, with the port building stage 1 at width 0.25."""
    monkeypatch.setitem(STAGE_MODELS, 1, functools.partial(PGUNet1, width=0.25))
    return narrow_pth


@pytest.fixture
def narrow_jax(tmp_path, monkeypatch):
    """(JAX dir, .pth) of seeded stage-1 variables at width 0.25, with both
    packages building stage 1 at that width."""
    v = jax_variables(1, width=0.25, seed=44)
    jax_save_checkpoint(tmp_path / "seg", v, metadata={"stage": 1})
    save_checkpoint(tmp_path / "seg.pth", state_dict_from_jax(v), stage=1, epoch=0)
    monkeypatch.setitem(STAGE_MODELS, 1, functools.partial(PGUNet1, width=0.25))
    monkeypatch.setitem(jax_pgunet.STAGE_MODELS, 1,
                        functools.partial(jax_pgunet.STAGE_MODELS[1], width=0.25))
    return str(tmp_path / "seg"), str(tmp_path / "seg.pth")


def _images(n, seed, px=32):
    return np.random.default_rng(seed).random((n, px, px, 3), dtype=np.float32)


def _maps_match_jax(got, want):
    """(preds, probs, unc) against JAX's: maps 1e-4, preds away from the threshold."""
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=TOL, rtol=0)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=TOL, rtol=0)
    near = np.abs(np.asarray(want[1]) - 0.5) < TOL
    np.testing.assert_array_equal(got[0][~near], np.asarray(want[0])[~near])


def _same(got, want, atol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_data_parallel_predictor_matches_jax(ckpts):
    jdir, pth = ckpts["seg"]
    x = _images(4, 0)
    port = Predictor(pth, buckets=(4,), dtype=None, mesh=cpu_mesh(2), device="cpu")
    want = JaxPredictor(jdir, buckets=(4,), dtype=None, mesh=jax_make_mesh(n_data=2))(x)
    _maps_match_jax(port(x), want)


@pytest.mark.parametrize("n_data", [2, 4])
def test_data_parallel_predictor_matches_unsharded(n_data, narrow):
    """Ragged requests route, pad and chunk as on one device."""
    pm = Predictor(narrow, buckets=(4, 8), dtype=None, mesh=cpu_mesh(n_data), device="cpu")
    ps = Predictor(narrow, buckets=(4, 8), dtype=None, device="cpu")
    assert pm.device == CPU and [d for d, _ in pm._rows] == [CPU] * n_data
    assert all(m is pm.model for _, m in pm._rows)  # one replica per distinct device
    for n, seed in ((1, 1), (5, 2), (11, 3)):
        got, want = pm(_images(n, seed)), ps(_images(n, seed))
        assert got[0].shape[0] == n
        _same(got, want, 1e-6)


def distinct_mesh(n_data, n_model=1):
    return make_mesh(n_data, n_model,
                     devices=[torch.device("cpu", i) for i in range(n_data * n_model)])


def _replica(pm):
    """The model of ``pm``'s second data row: a copy of ``pm.model``."""
    home, model = pm._rows[1]
    assert home == pm.mesh.device_at(data=1) and pm._rows[0][0] == pm.device
    assert model is not pm.model
    whole = pm.model.state_dict()
    mine = model.state_dict()  # under shard_model, less the column-parallel blocks'
    assert mine and set(mine) <= set(whole)
    for k, t in mine.items():
        assert t.data_ptr() != whole[k].data_ptr() and torch.equal(t, whole[k]), k
    return model


def test_mesh_predictors_serve_a_replica_per_distinct_device(ckpts):
    """Data-parallel and column-parallel over distinct devices, float32 and
    int8: each data row's own replica answers as the unsharded predictor."""
    pth = ckpts["seg"][1]
    x = _images(4, 15)
    ps = Predictor(pth, buckets=(4,), dtype=None, device="cpu")
    for shape, tp in (((2, 1), False), ((2, 2), True)):
        pm = Predictor(pth, buckets=(4,), dtype=None, mesh=distinct_mesh(*shape), shard_model=tp,
                       device="cpu")
        replica = _replica(pm)
        assert pm._rows[0][1] is pm.model or tp
        assert tp == any(isinstance(m, tensor._ColumnParallelDoubleConv)
                         for m in replica.modules())
        _same(pm(x), ps(x), 1e-5 if tp else 1e-6)
    quant = dict(buckets=(4,), dtype=None, quantize=True, calibration_batches=[_images(4, 5)],
                 device="cpu")
    qs = Predictor(pth, **quant)
    qm = Predictor(pth, mesh=distinct_mesh(2, 2), shard_model=True, **quant)
    for g, w in zip(qm(x), qs(x)):
        np.testing.assert_array_equal(g, w)
    got_points, want_points = {}, {}
    _replica(qm).forward_nhwc(torch.from_numpy(x[:2]), got_points)
    qs.model.forward_nhwc(torch.from_numpy(x[:2]), want_points)
    assert sorted(got_points) == sorted(want_points)
    for k in want_points:
        assert torch.equal(got_points[k], want_points[k]), k


def test_mesh_predictor_refusals(narrow):
    with pytest.raises(ValueError, match="do not divide"):
        Predictor(narrow, buckets=(8, 12), dtype=None, mesh=cpu_mesh(8), device="cpu")
    model_only = Mesh(np.asarray([CPU] * 2, dtype=object), ("model",))
    for mesh in (model_only, object()):
        with pytest.raises(ValueError, match="'data' axis"):
            Predictor(narrow, buckets=(8,), dtype=None, mesh=mesh, device="cpu")


def test_tensor_parallel_predictor_matches_jax_and_unsharded(ckpts):
    """shard_model=True: the 512- and 256-wide convs column-parallel over
    'model'; the model the predictor exports is left whole."""
    jdir, pth = ckpts["seg"]
    x = _images(2, 4)
    ps = Predictor(pth, buckets=(2,), dtype=None, device="cpu")
    for shape in ((1, 2), (2, 2)):
        pm = Predictor(pth, buckets=(2,), dtype=None, mesh=cpu_mesh(*shape), shard_model=True,
                       device="cpu")
        wrapped = [m for _, row in pm._rows for m in row.modules()
                   if isinstance(m, tensor._ColumnParallelDoubleConv)]
        assert len(wrapped) == 3 * shape[0]  # inc, down4, up1 per data row
        assert not any(isinstance(m, tensor._ColumnParallelDoubleConv)
                       for m in pm.model.modules())
        _same(pm(x), ps(x), 1e-5)
    jm = JaxPredictor(jdir, buckets=(2,), dtype=None, mesh=jax_make_mesh(n_data=1, n_model=2),
                      shard_model=True)
    _maps_match_jax(pm(x), jm(x))
    live = dict(buckets=(2,), dtype=None, fold_bn=False, device="cpu")  # BN on each slice
    _same(Predictor(pth, mesh=cpu_mesh(1, 2), shard_model=True, **live)(x),
          Predictor(pth, **live)(x), 1e-5)


def test_int8_mesh_predictor_points_equal_unsharded(ckpts):
    """Full width, so that the int8 convs of 512 and 256 outputs split too."""
    pth = ckpts["seg"][1]
    calib = [_images(4, 5)]
    x = _images(4, 6)
    ps = Predictor(pth, buckets=(4,), dtype=None, quantize=True, calibration_batches=calib,
                   device="cpu")
    want = ps(x)
    for shape, tp in (((2, 1), False), ((2, 2), True)):
        pm = Predictor(pth, buckets=(4,), dtype=None, quantize=True, calibration_batches=calib,
                       mesh=cpu_mesh(*shape), shard_model=tp, device="cpu")
        assert tp == any(isinstance(m, tensor._ColumnParallelQConv)
                         for m in pm._rows[1][1].modules())
        for g, w in zip(pm(x), want):
            np.testing.assert_array_equal(g, w)
        xt = torch.from_numpy(x[:2])
        got_points, want_points = {}, {}
        pm._rows[1][1].forward_nhwc(xt, got_points)
        ps.model.forward_nhwc(xt, want_points)
        assert sorted(got_points) == sorted(want_points)
        for k in want_points:
            assert torch.equal(got_points[k], want_points[k]), k


def test_int8_mesh_predictor_matches_jax(narrow_jax):
    """Both packages at width 0.25 (JAX's int8 conv is slow on the CPU)."""
    jdir, pth = narrow_jax
    quant = dict(buckets=(4,), dtype=None, quantize=True, calibration_batches=[_images(4, 5)])
    x = _images(4, 6)
    got = Predictor(pth, mesh=cpu_mesh(2), device="cpu", **quant)(x)
    _maps_match_jax(got, JaxPredictor(jdir, mesh=jax_make_mesh(n_data=2), **quant)(x))


def test_classification_mesh_predictor(ckpts):
    """Data-parallel against JAX's mesh predictor; MC dropout and TP against
    the unsharded port (MC masks: the bucket's, drawn as one device draws
    them, split by row)."""
    jdir, pth = ckpts["cls"]
    x = _images(4, 7)
    kw = dict(task_type="classification", num_classes=7, dtype=None, buckets=(4,), device="cpu")
    labels, probs = Predictor(pth, mesh=cpu_mesh(2), **kw)(x)
    j_labels, j_probs = JaxPredictor(jdir, task_type="classification", num_classes=7, dtype=None,
                                     buckets=(4,), mesh=jax_make_mesh(n_data=2))(x)
    np.testing.assert_allclose(probs, np.asarray(j_probs), atol=TOL, rtol=0)
    np.testing.assert_array_equal(labels, np.asarray(j_labels))
    mc = Predictor(pth, mc_dropout=4, mesh=cpu_mesh(2), **kw)(x)
    _same(mc, Predictor(pth, mc_dropout=4, **kw)(x), 1e-6)
    assert mc[2].shape == (4,) and mc[2].any()
    tp = Predictor(pth, mesh=cpu_mesh(1, 2), shard_model=True, **kw)(x)
    _same(tp, Predictor(pth, **kw)(x), 1e-5)


def test_mesh_stream_batching_server_and_export(narrow, tmp_path):
    pm = Predictor(narrow, buckets=(4,), dtype=None, mesh=cpu_mesh(2), device="cpu")
    ps = Predictor(narrow, buckets=(4,), dtype=None, device="cpu")
    xs = [_images(4, 8), _images(3, 9)]
    got = list(pm.stream(iter(xs)))
    for x, outs in zip(xs, got):
        _same(outs, pm(x), 0.0)
    server = BatchingServer(pm, max_latency_ms=30.0)
    images = _images(4, 10)
    futs = [server.submit(im) for im in images]
    outs = [f.result(timeout=60) for f in futs]
    server.close()
    ref = ps(images)
    for i, out in enumerate(outs):
        _same(out, tuple(r[i] for r in ref), 1e-6)
    art = pm.export(tmp_path / "art")
    exported = ExportedPredictor(art, device="cpu")
    x = _images(4, 11)
    _same(exported(x), pm(x), 1e-6)
    _same(exported(x), ps(x), 0.0)  # the unsharded model's artifact


def test_registry_passes_the_mesh_through(narrow):
    reg = ServingRegistry()
    mesh = cpu_mesh(2)
    p = reg.register("seg", narrow, buckets=(2,), dtype=None, mesh=mesh, device="cpu")
    s = reg.register_slide("slide", narrow, mesh=mesh, device="cpu")
    assert p.mesh is mesh and s.mesh is mesh
    x = _images(2, 12)
    _same(reg.predict("seg", x), Predictor(narrow, buckets=(2,), dtype=None, device="cpu")(x),
          1e-6)
    assert reg.submit("slide", x[0]).result(timeout=60)[1].shape == (32, 32, 1)
    reg.close()


@pytest.mark.parametrize("shape,w_axis", [((2, 1), None), ((2, 2), "model")])
def test_mesh_slide_predictor_matches_jax(shape, w_axis, ckpts):
    jdir, pth = ckpts["seg"]
    x = (np.random.default_rng(13).random((1, 37, 45, 3)) * 255).astype(np.uint8)
    port = SlidePredictor(pth, mesh=cpu_mesh(*shape), w_axis=w_axis, device="cpu")
    assert port._divisor == (2 * shape[0], 2 * shape[1])
    want = JaxSlidePredictor(jdir, mesh=jax_make_mesh(n_data=shape[0], n_model=shape[1]),
                             w_axis=w_axis)(x)
    got = port(x)
    assert [g.shape for g in got] == [(1, 37, 45, 1)] * 3
    _maps_match_jax(got, want)
    with pytest.raises(ValueError, match="not a mesh axis"):
        SlidePredictor(pth, mesh=cpu_mesh(2), w_axis="rows", device="cpu")


def test_mesh_slide_predictor_pads_to_pad_multiple_as_jax(ckpts):
    jdir, pth = ckpts["seg"]
    x = (np.random.default_rng(16).random((1, 37, 45, 3)) * 255).astype(np.uint8)
    port = SlidePredictor(pth, mesh=cpu_mesh(2), pad_multiple=24, device="cpu")
    assert port._divisor == (24, 24)  # lcm(2 shards * 2, 24), lcm(2, 24): 48 x 48 padded
    want = JaxSlidePredictor(jdir, mesh=jax_make_mesh(n_data=2), pad_multiple=24)(x)
    _maps_match_jax(port(x), want)


class _OneSlide:
    def __init__(self, seed):
        g = np.random.default_rng(seed)
        self.img = (g.random((50, 60, 3)) * 255).astype(np.uint8)
        self.mask = (g.random((50, 60)) > 0.5).astype(np.uint8)

    def __len__(self):
        return 1

    def load_raw(self, idx):
        return self.img, self.mask


def test_mesh_native_evaluation_matches_jax(ckpts):
    jdir, pth = ckpts["seg"]
    ds = _OneSlide(14)
    ev = MoNuSegEvaluator(pth, device="cpu")
    got = ev.evaluate_dataset_native(ds, mesh=cpu_mesh(2, 2), w_axis="model")
    want = JaxEvaluator(jdir).evaluate_dataset_native(
        ds, mesh=jax_make_mesh(n_data=2, n_model=2), w_axis="model")
    assert got["native_resolution"] and got["num_samples"] == 1
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=TOL), k
    # the slide predictor's preds are what the evaluator scored
    preds = SlidePredictor(pth, mesh=cpu_mesh(2, 2), w_axis="model", device="cpu")(
        ds.img[None])[0]
    inter = float((preds[0, ..., 0] * ds.mask).sum())
    dice = 2 * inter / (float(preds.sum()) + float(ds.mask.sum()) + 1e-8)
    assert got["dice_mean"] == pytest.approx(dice, abs=1e-6)
    bf16 = ev.evaluate_dataset_native(ds, mesh=cpu_mesh(2), dtype=torch.bfloat16)
    assert set(bf16) == set(got) and abs(bf16["dice_mean"] - got["dice_mean"]) < 0.05
    assert ev.evaluate_dataset_native(ds, dtype=torch.bfloat16) == ev.evaluate_dataset_native(ds)


def test_serve_command_with_mesh_on_the_cpu(narrow, monkeypatch):
    """``serve --mesh 2 --device cpu`` registers every kind of model on a
    mesh of the CPU twice and answers as without it; the default buckets
    scale by the data axis."""
    captured = {}

    def fake_serve_forever(self):
        captured["registry"] = self.registry

    monkeypatch.setattr(http_server.ServingHTTPServer, "serve_forever", fake_serve_forever)
    assert serve_cli.main(["--model", f"m={narrow}", "--slide_model", f"s={narrow}",
                           "--mesh", "2", "--port", "0", "--host", "127.0.0.1",
                           "--device", "cpu"]) == 0
    reg = captured["registry"]
    p = reg.get("m")
    assert p.mesh.shape == {"data": 2, "model": 1} and p.buckets == (2, 16, 128)
    assert reg.get("s").mesh.shape == {"data": 2, "model": 1}
    x = _images(3, 15)
    _same(reg.predict("m", x), Predictor(narrow, buckets=(1, 8, 64), dtype=None,
                                         device="cpu")(x), 1e-6)


@pytest.mark.parametrize("mesh", ["2", "2,2"])
def test_test_monuseg_native_res_with_mesh_on_the_cpu(mesh, narrow, tmp_path):
    """``test_monuseg --eval_full --native_res --mesh`` on 64 px tiles
    (divisible either way): the metrics of the run without the mesh."""
    write_monuseg_tree(tmp_path / "data")
    argv = ["--model", narrow, "--data", str(tmp_path / "data"), "--eval_full", "--native_res",
            "--num_images", "0", "--device", "cpu"]
    plain = test_monuseg_cli.main(argv + ["--output_dir", str(tmp_path / "plain")])["metrics"]
    got = test_monuseg_cli.main(argv + ["--mesh", mesh, "--output_dir", str(tmp_path / "m")])
    assert (tmp_path / "m" / "evaluation_results_native.json").exists()
    for k, v in plain.items():
        assert got["metrics"][k] == pytest.approx(v, abs=TOL), k
