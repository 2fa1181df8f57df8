"""The port's HTTP front end (``eval/http_server.py``) and ``ugpg-torch-serve``
against the JAX package's, on the CPU: the cases of
``tests/test_http_serving.py``.

Weights: seeded JAX variables of a stage-1 segmentation model and a
stage-1 Herlev classifier (5 classes) at full width, converted with the
port's ``io/from_jax.py``; the port serves the ``.pth`` files, the JAX
package the checkpoints.

Tolerances: an npz or JSON response equals the port's direct predictor
call bit for bit (the same function on the same bytes); against the JAX
package's Predictor, probabilities and uncertainty 1e-4 (float32 on both
sides, summed in other orders), preds equal except within 1e-4 of the
threshold.
"""

import io
import json
import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_models import jax_variables
from ugpg_tpu.eval.http_server import _model_info as jax_model_info
from ugpg_tpu.eval.serving import Predictor as JaxPredictor
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu_torch.cli import serve as serve_cli
from ugpg_tpu_torch.eval import http_server as hs
from ugpg_tpu_torch.eval.http_server import ServingHTTPServer
from ugpg_tpu_torch.eval.serving import ServingRegistry
from ugpg_tpu_torch.io.checkpoint import full_classifier_state_dict, save_checkpoint
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax

TOL = 1e-4


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("http_ckpts")
    v = jax_variables(1, width=1.0, seed=41)
    jax_save_checkpoint(d / "seg", v, metadata={"stage": 1})
    save_checkpoint(d / "seg.pth", state_dict_from_jax(v), stage=1, epoch=0)
    vc = jax_cls_variables(1, 5, seed=42)
    jax_save_checkpoint(d / "cls", vc, metadata={"stage": 1})
    save_checkpoint(d / "cls.pth", full_classifier_state_dict(state_dict_from_jax(vc), 1),
                    stage=1, epoch=0)
    return {k: (str(d / k), str(d / f"{k}.pth")) for k in ("seg", "cls")}


@pytest.fixture(scope="module")
def served(ckpts):
    registry = ServingRegistry(max_latency_ms=20.0)
    registry.register("seg", ckpts["seg"][1], buckets=(1, 4), dtype=None, device="cpu")
    registry.register("cls", ckpts["cls"][1], task_type="classification", num_classes=5,
                      buckets=(1, 4), dtype=None, device="cpu")
    registry.register("mc", ckpts["cls"][1], task_type="classification", num_classes=5,
                      buckets=(1, 4), dtype=None, mc_dropout=4, device="cpu")
    server = ServingHTTPServer(registry, port=0)
    port = server.start()
    yield registry, port
    server.close()
    registry.close()


@pytest.fixture(scope="module")
def jax_seg(ckpts):
    return JaxPredictor(ckpts["seg"][0], buckets=(1, 4), dtype=None)


def _request(port, method, path, body=None, ctype=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    headers = {"Content-Type": ctype} if ctype else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _images(n, seed):
    return np.random.default_rng(seed).random((n, 32, 32, 3), dtype=np.float32)


def test_health_and_model_metadata_keys_are_jax_s(served, jax_seg):
    registry, port = served
    status, ctype, data = _request(port, "GET", "/v1/health")
    assert status == 200 and ctype == "application/json"
    assert json.loads(data) == {"status": "ok", "models": ["cls", "mc", "seg"]}

    status, _, data = _request(port, "GET", "/v1/models")
    models = {m["name"]: m for m in json.loads(data)["models"]}
    assert models["seg"]["outputs"] == ["preds", "probs", "uncertainty"]
    assert models["cls"]["outputs"] == ["labels", "probs"]
    assert models["mc"]["outputs"] == ["labels", "probs", "mc_variance"]
    assert models["seg"] == jax_model_info("seg", jax_seg)  # every key and value

    status, _, data = _request(port, "GET", "/v1/models/seg")
    assert status == 200 and json.loads(data)["buckets"] == [1, 4]
    assert _request(port, "GET", "/v1/models/nope")[0] == 404


def test_npy_batch_matches_direct_call_and_jax(served, jax_seg):
    registry, port = served
    x = _images(3, 1)
    status, ctype, data = _request(port, "POST", "/v1/models/seg:predict",
                                   body=_npy_bytes(x), ctype="application/x-npy")
    assert status == 200 and ctype == "application/x-npz"
    out = np.load(io.BytesIO(data))
    assert set(out.files) == {"preds", "probs", "uncertainty"}
    for name, want in zip(("preds", "probs", "uncertainty"), registry.predict("seg", x)):
        np.testing.assert_array_equal(out[name], want)
    w_preds, w_probs, w_unc = (np.asarray(o) for o in jax_seg(x))
    assert w_probs.std() > 0.05
    np.testing.assert_allclose(out["probs"], w_probs, atol=TOL, rtol=0)
    np.testing.assert_allclose(out["uncertainty"], w_unc, atol=TOL, rtol=0)
    differ = out["preds"] != w_preds
    assert np.all(np.abs(w_probs[differ] - 0.5) < TOL)


@pytest.mark.parametrize("model", ["seg", "cls", "mc"])
def test_single_images_micro_batched_concurrently(model, served):
    """Concurrent single-image requests coalesce and each gets its own
    image's answer."""
    registry, port = served
    images = _images(4, 2)
    results = [None] * 4

    def call(i):
        status, _, data = _request(port, "POST", f"/v1/models/{model}:predict",
                                   body=_npy_bytes(images[i]), ctype="application/x-npy")
        assert status == 200
        results[i] = np.load(io.BytesIO(data))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    names = hs.output_names(registry.get(model))
    for i in range(4):
        assert sorted(results[i].files) == sorted(names)
        if model == "mc":
            # the dropout masks are drawn per bucket row, so an image's
            # answer depends on the group it lands in: shapes and
            # consistency only
            r = results[i]
            assert r["probs"].shape == (5,) and r["mc_variance"].shape == ()
            assert r["labels"] == r["probs"].argmax() and r["mc_variance"] >= 0
            continue
        want = registry.predict(model, images[i][None])
        for name, w in zip(names, want):
            # a group of up to 4 runs in bucket 4, the direct call in bucket
            # 1: other padding, the same per-image function
            np.testing.assert_allclose(results[i][name], w[0], atol=1e-5, rtol=0)


def test_json_classification_roundtrip(served):
    registry, port = served
    x = _images(2, 3)
    status, _, data = _request(port, "POST", "/v1/models/cls:predict",
                               body=json.dumps({"instances": x.tolist()}).encode(),
                               ctype="application/json")
    assert status == 200
    preds = json.loads(data)["predictions"]
    want_labels, want_probs = registry.predict("cls", x)
    assert preds["labels"] == want_labels.tolist()
    np.testing.assert_allclose(np.asarray(preds["probs"]), want_probs, atol=1e-6)


def test_stats_counters(served):
    registry, port = served
    x = _images(2, 4)
    _request(port, "POST", "/v1/models/seg:predict", body=_npy_bytes(x),
             ctype="application/x-npy")
    reg_single = registry.submit("seg", x[0]).result(60)
    assert reg_single[1].shape == (32, 32, 1)
    status, _, data = _request(port, "GET", "/v1/stats")
    assert status == 200
    seg = json.loads(data)["seg"]
    assert seg["predictor"]["requests"] >= 1 and seg["predictor"]["images"] >= 2
    assert seg["predictor"]["device_calls"] >= 1 and seg["predictor"]["latency_ms"]["p50"] > 0
    b = seg["batcher"]
    assert b["submitted"] >= b["groups"] >= 1 and b["mean_group"] >= 1.0


ERRORS = {
    "unknown-model": ("/v1/models/ghost:predict", "npy-ok", "application/x-npy", 404),
    "bad-shape": ("/v1/models/seg:predict", "npy-2d", "application/x-npy", 400),
    "content-type": ("/v1/models/seg:predict", b"bytes", "text/plain", 415),
    "malformed-json": ("/v1/models/seg:predict", b"{nope", "application/json", 400),
    "json-no-instances": ("/v1/models/seg:predict", b'{"x": 1}', "application/json", 400),
    "empty-body": ("/v1/models/seg:predict", b"", "application/x-npy", 400),
    "bad-route": ("/v1/other", b"x", "application/x-npy", 404),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_paths(case, served):
    _, port = served
    path, body, ctype, code = ERRORS[case]
    body = {"npy-ok": _npy_bytes(_images(1, 5)),
            "npy-2d": _npy_bytes(np.zeros((2, 5)))}.get(body, body)
    status, _, data = _request(port, "POST", path, body=body, ctype=ctype)
    assert status == code and "error" in json.loads(data)
    if case == "unknown-model":
        assert "unknown model" in json.loads(data)["error"]


def test_error_response_closes_keepalive_connection(served):
    """An error path may leave the body unread; the connection must close
    or the leftover bytes would be parsed as the next request."""
    _, port = served
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/models/ghost:predict", body=b"x" * 4096,
                 headers={"Content-Type": "application/x-npy"})
    resp = conn.getresponse()
    assert resp.status == 404
    assert (resp.getheader("Connection") or "").lower() == "close"
    resp.read()
    conn.close()


@pytest.mark.parametrize("case", ["wires", "nothing", "bad-spec", "mesh"])
def test_serve_cli(case, ckpts, tmp_path, monkeypatch):
    """The command line parses specs, registers every kind of model and
    starts the server (serve_forever stubbed); with --mesh 2 on the CPU the
    models serve on a mesh of the CPU twice and answer as without it."""
    seg = ckpts["seg"][1]
    if case == "wires":
        from ugpg_tpu_torch.eval.serving import Predictor

        art = Predictor(seg, buckets=(1,), dtype=None, device="cpu").export(tmp_path / "art")
        captured = {}

        def fake_serve_forever(self):
            captured["names"] = self.registry.names()
            captured["port"] = self.port
            captured["kinds"] = {n: type(self.registry.get(n)).__name__
                                 for n in self.registry.names()}
            captured["dtype"] = self.registry.get("m").dtype

        monkeypatch.setattr(hs.ServingHTTPServer, "serve_forever", fake_serve_forever)
        assert serve_cli.main(["--model", f"m={seg}", "--cls_model", f"c={ckpts['cls'][1]}",
                               "--classes", "5", "--mc_dropout", "4", "--slide_model",
                               f"s={seg}", "--artifact", f"a={art}", "--buckets", "1", "2",
                               "--host", "127.0.0.1", "--port", "0", "--device", "cpu"]) == 0
        assert captured["names"] == ["a", "c", "m", "s"] and captured["port"] > 0
        assert captured["kinds"] == {"a": "ExportedPredictor", "c": "Predictor",
                                     "m": "Predictor", "s": "SlidePredictor"}
        assert captured["dtype"] == torch.float32
        return
    if case == "mesh":
        from ugpg_tpu_torch.eval.serving import Predictor

        captured = {}
        monkeypatch.setattr(hs.ServingHTTPServer, "serve_forever",
                            lambda self: captured.setdefault("registry", self.registry))
        assert serve_cli.main(["--model", f"m={seg}", "--mesh", "2", "--buckets", "2",
                               "--port", "0", "--device", "cpu"]) == 0
        p = captured["registry"].get("m")
        assert p.mesh.shape == {"data": 2, "model": 1}
        x = _images(2, 7)
        for got, want in zip(p(x), Predictor(seg, buckets=(2,), dtype=None, device="cpu")(x)):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        return
    argv = {"nothing": ["--port", "0"], "bad-spec": ["--model", "missing-equals"]}[case]
    with pytest.raises(SystemExit):
        serve_cli.main(argv)
