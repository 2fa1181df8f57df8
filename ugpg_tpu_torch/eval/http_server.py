"""HTTP front end over ``ServingRegistry`` (counterpart of
``ugpg_tpu/eval/http_server.py``; the standard library only).

A threaded HTTP endpoint over the registry's predictors, where
concurrent single-image requests from independent clients coalesce into
one device call through the deadline-bounded micro-batcher
(``BatchingServer``).

Endpoints:

* ``GET  /v1/health`` -- liveness and the registered model names.
* ``GET  /v1/models`` -- metadata of every model (task, stage, resolution,
  buckets, input dtype, outputs).
* ``GET  /v1/models/<name>`` -- metadata of one model.
* ``GET  /v1/stats`` -- per-model request counters, latency percentiles
  (sliding window) and the micro-batcher's coalescing.
* ``POST /v1/models/<name>:predict`` -- inference.

Request bodies of ``:predict``:

* ``application/x-npy`` -- one ``.npy`` tensor.  Shape ``(H, W, 3)``: one
  image, sent through the micro-batcher so that concurrent callers share
  a device call.  Shape ``(B, H, W, 3)``: a batch, served at once through
  the bucket routing.  The response is ``application/x-npz`` with one named
  array per output (segmentation: ``preds``, ``probs``, ``uncertainty``;
  classification: ``labels``, ``probs`` and with MC dropout
  ``mc_variance``).
* ``application/json`` -- ``{"instances": <nested lists>}`` for small or
  debugging payloads; response ``{"predictions": {<name>: lists}}``.

An error response closes the connection (its body may be unread).

Example:
    registry = ServingRegistry()
    registry.register("seg", "out/ug_pgunet_stage4_best.pth", buckets=(1, 8))
    server = ServingHTTPServer(registry, port=8000)
    server.start()          # returns the bound port
    ...
    server.close()
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["ServingHTTPServer", "output_names"]

_SEG_OUTPUTS = ("preds", "probs", "uncertainty")
_CLS_OUTPUTS = ("labels", "probs")
_CLS_MC_OUTPUTS = ("labels", "probs", "mc_variance")

#: refuse request bodies larger than this (a batch of 64 256 px float32
#: images is 50 MB; anything past this is a misdirected upload)
MAX_BODY_BYTES = 512 * 1024 * 1024


def output_names(predictor) -> tuple[str, ...]:
    """Named outputs for a predictor, by task type (+ MC-dropout variance
    when the predictor emits a third classification output)."""
    if predictor.task_type == "classification":
        if getattr(predictor, "_n_outputs", 2) == 3:
            return _CLS_MC_OUTPUTS
        return _CLS_OUTPUTS
    return _SEG_OUTPUTS


def _model_info(name: str, p) -> dict:
    return {
        "name": name,
        "task_type": p.task_type,
        "stage": p.stage,
        "resolution": p.resolution,
        "buckets": list(p.buckets),
        "input_dtype": np.dtype(p.input_dtype).name,  # a numpy dtype in the port
        "outputs": list(output_names(p)),
    }


class _Handler(BaseHTTPRequestHandler):
    # set by ServingHTTPServer subclassing
    registry = None
    verbose = False
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- util
    def log_message(self, fmt, *args):  # quiet by default
        if self.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _error(self, code: int, message: str) -> None:
        # an error path may not have read the request body; on a keep-alive
        # (HTTP/1.1) connection the unread bytes would be parsed as the next
        # request line, so the connection closes after an error response
        self.close_connection = True
        self._send_json(code, {"error": message})

    # ------------------------------------------------------------- GET
    def do_GET(self):  # noqa: N802 (http.server API)
        reg = self.registry
        if self.path == "/v1/health":
            self._send_json(200, {"status": "ok", "models": reg.names()})
        elif self.path == "/v1/stats":
            self._send_json(200, reg.stats())
        elif self.path == "/v1/models":
            self._send_json(
                200,
                {"models": [_model_info(n, reg.get(n)) for n in reg.names()]},
            )
        elif self.path.startswith("/v1/models/"):
            name = self.path[len("/v1/models/"):]
            try:
                self._send_json(200, _model_info(name, reg.get(name)))
            except KeyError:
                self._error(404, f"unknown model {name!r}")
        else:
            self._error(404, f"no route for GET {self.path}")

    # ------------------------------------------------------------- POST
    def do_POST(self):  # noqa: N802
        if not self.path.startswith("/v1/models/") or not self.path.endswith(
            ":predict"
        ):
            self._error(404, f"no route for POST {self.path}")
            return
        name = self.path[len("/v1/models/"):-len(":predict")]
        try:
            predictor = self.registry.get(name)
        except KeyError:
            self._error(404, f"unknown model {name!r}")
            return

        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._error(400, "bad Content-Length")
            return
        if length <= 0:
            self._error(400, "empty request body")
            return
        if length > MAX_BODY_BYTES:
            self._error(413, f"request body over {MAX_BODY_BYTES} bytes")
            return
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()

        try:
            if ctype == "application/x-npy":
                arr = np.load(io.BytesIO(body), allow_pickle=False)
                as_json = False
            elif ctype == "application/json":
                payload = json.loads(body)
                if "instances" not in payload:
                    raise ValueError('JSON body must contain "instances"')
                arr = np.asarray(payload["instances"], dtype=np.float32)
                as_json = True
            else:
                self._error(
                    415,
                    f"unsupported Content-Type {ctype!r}; use "
                    "application/x-npy or application/json",
                )
                return
            outs = self._predict(predictor, name, arr)
        except (ValueError, json.JSONDecodeError) as exc:
            self._error(400, str(exc))
            return
        except Exception as exc:  # device / registry failure
            self._error(500, f"{type(exc).__name__}: {exc}")
            return

        names = output_names(predictor)
        if as_json:
            self._send_json(
                200,
                {"predictions": {k: np.asarray(v).tolist()
                                 for k, v in zip(names, outs)}},
            )
        else:
            buf = io.BytesIO()
            np.savez(buf, **dict(zip(names, outs)))
            self._send(200, buf.getvalue(), "application/x-npz")

    def _predict(self, predictor, name: str, arr: np.ndarray):
        if arr.ndim == 3:
            if arr.shape[-1] != 3:
                raise ValueError(
                    f"single image must be (H, W, 3), got {arr.shape}"
                )
            # micro-batched: concurrent HTTP callers share one device call
            return self.registry.submit(name, arr).result()
        if arr.ndim == 4:
            if arr.shape[-1] != 3:
                raise ValueError(
                    f"batch must be (B, H, W, 3), got {arr.shape}"
                )
            return predictor(arr)
        raise ValueError(
            f"expected (H, W, 3) or (B, H, W, 3), got shape {arr.shape}"
        )


class ServingHTTPServer:
    """Threaded HTTP endpoint over a ``ServingRegistry``.

    ``start()`` serves on a daemon thread and returns the bound port
    (``port=0`` picks a free one).  ``close()`` stops the listener; the
    registry and its micro-batchers stay usable and are the caller's to
    close.
    """

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 8000,
                 verbose: bool = False):
        self.registry = registry

        class Handler(_Handler):
            pass

        Handler.registry = registry
        Handler.verbose = verbose
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def start(self) -> int:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def serve_forever(self) -> None:
        """Blocking serve (the command line's); Ctrl-C (SIGINT) returns."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()
