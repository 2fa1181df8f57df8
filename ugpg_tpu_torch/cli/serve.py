"""Serve checkpoints and exported artifacts over HTTP (counterpart of
``ugpg_tpu/cli/serve.py``).

    python -m ugpg_tpu_torch.cli.serve --model seg=OUT/ug_pgunet_stage4_best.pth \\
        --cls_model cls=OUT/herlev_stage4_best.pth --classes 7 [--mc_dropout 8] \\
        --slide_model slide=OUT/ug_pgunet_stage4_best.pth --artifact seg_v2=exported/stage4 \\
        [--port 8000] [--buckets 1 8 64] [--uint8] [--max_latency_ms 5] [--mesh N[,M]] \\
        [--device cpu]

Endpoints: ``GET /v1/health``, ``GET /v1/models[/<name>]``, ``GET
/v1/stats``, ``POST /v1/models/<name>:predict`` (``application/x-npy`` or
``application/json``), see ``eval/http_server.py``.  Single-image requests
from concurrent clients share device calls through the micro-batcher.
Checkpoints (``.pth`` files or msgpack or orbax directories, ``io/checkpoint.py``)
serve in their own float32.  Prints ``serving [names] on
http://HOST:PORT`` once it listens (``--port 0`` picks a free port) and
stops on SIGINT.  ``--mesh N[,M]`` serves ``--model`` and ``--cls_model``
data-parallel over N devices (each bucket's rows split over them; buckets
must divide by N, and the default buckets scale by it), with M > 1 the
wide convs column-parallel over M, and ``--slide_model`` spatially
sharded, H over N and W over M (``cli.parse_mesh``: on ``--device cpu`` the
CPU N x M times, on ``cuda`` the visible cards); artifacts serve on one
device.  Under a coordinator (``UGPG_COORDINATOR_ADDRESS`` or torchrun)
``--mesh`` exits 2: the JAX command cannot serve across processes.
"""

from __future__ import annotations

import argparse
import sys


def _split_spec(spec: str) -> tuple[str, str]:
    if "=" not in spec:
        raise SystemExit(f"model spec must be name=path, got {spec!r}")
    name, path = spec.split("=", 1)
    return name, path


def resolve_buckets(buckets, mesh=None) -> list[int]:
    """The buckets to serve: (1, 8, 64) per device unless given, times the
    mesh's data axis (bucket 1 could never divide it).  Given buckets must
    divide by the data axis: the command exits with a message otherwise."""
    if buckets is None:
        scale = mesh.shape["data"] if mesh is not None else 1
        return [1 * scale, 8 * scale, 64 * scale]
    if mesh is not None:
        n = mesh.shape["data"]
        bad = [b for b in buckets if b % n]
        if bad:
            raise SystemExit(
                f"--buckets {bad} do not divide by the mesh data axis ({n}); every bucket is "
                f"split across the data axis, so pass multiples of {n}")
    return list(buckets)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HTTP serving front end (PyTorch/CUDA)")
    p.add_argument("--model", action="append", default=[], metavar="NAME=CKPT",
                   help="segmentation checkpoint (.pth or a JAX checkpoint directory) to "
                        "serve (repeatable)")
    p.add_argument("--cls_model", action="append", default=[], metavar="NAME=CKPT",
                   help="classification checkpoint (.pth or a JAX checkpoint directory) "
                        "to serve (repeatable)")
    p.add_argument("--slide_model", action="append", default=[], metavar="NAME=CKPT",
                   help="segmentation checkpoint served at native resolution: requests of "
                        "any size run on the whole image (repeatable)")
    p.add_argument("--pad_multiple", type=int, default=None,
                   help="--slide_model: pad sizes up to multiples of N")
    p.add_argument("--artifact", action="append", default=[], metavar="NAME=DIR",
                   help="exported artifact directory, bucket (Predictor.export) or slide "
                        "(SlidePredictor.export), told apart by its manifest (repeatable)")
    p.add_argument("--mc_dropout", type=int, default=0, metavar="N",
                   help="classification models: N MC-dropout passes per request; adds a "
                        "per-sample mc_variance output")
    p.add_argument("--classes", type=int, default=7, help="num_classes of --cls_model entries")
    p.add_argument("--buckets", type=int, nargs="+", default=None,
                   help="batch buckets (default 1 8 64)")
    p.add_argument("--uint8", action="store_true", help="serve raw uint8 RGB request tensors")
    p.add_argument("--mesh", type=str, default=None, metavar="N[,M]",
                   help="serve over an (N data x M model) device mesh: each bucket's rows "
                        "split over N (buckets must divide by N); M > 1 also runs the wide "
                        "convs column-parallel; --slide_model shards H over N and W over M")
    p.add_argument("--compact", action="store_true",
                   help="uint8 preds and float16 maps in responses")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_latency_ms", type=float, default=5.0,
                   help="micro-batcher deadline for single-image requests")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    return p


def build_registry(args, mesh=None):
    """The ``ServingRegistry`` the parsed ``args`` ask for, on ``mesh`` when
    given (``parse_mesh(args.mesh, args.device)``)."""
    import numpy as np

    from ugpg_tpu_torch.eval.serving import ServingRegistry

    registry = ServingRegistry(max_latency_ms=args.max_latency_ms)
    input_dtype = np.uint8 if args.uint8 else np.float32
    buckets = tuple(resolve_buckets(args.buckets, mesh))
    wide = mesh is not None and mesh.shape["model"] > 1
    for spec in args.model:
        name, ckpt = _split_spec(spec)
        registry.register(name, ckpt, buckets=buckets, input_dtype=input_dtype,
                          compact_output=args.compact, dtype=None, device=args.device,
                          mesh=mesh, shard_model=wide)
    for spec in args.cls_model:
        name, ckpt = _split_spec(spec)
        registry.register(name, ckpt, task_type="classification", num_classes=args.classes,
                          buckets=buckets, input_dtype=input_dtype, dtype=None,
                          mc_dropout=args.mc_dropout, device=args.device, mesh=mesh,
                          shard_model=wide)
    for spec in args.slide_model:
        name, ckpt = _split_spec(spec)
        # H shards over 'data'; a model axis > 1 shards W too: the 2-D halo grid
        registry.register_slide(name, ckpt, pad_multiple=args.pad_multiple,
                                compact_output=args.compact, device=args.device, mesh=mesh,
                                w_axis="model" if wide else None)
    for spec in args.artifact:
        name, path = _split_spec(spec)
        registry.register_artifact(name, path, device=args.device)
    return registry


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    if not (args.model or args.cls_model or args.slide_model or args.artifact):
        raise SystemExit("nothing to serve: pass --model/--cls_model/--slide_model/--artifact")
    from ugpg_tpu_torch.cli import SERVE_ACROSS_PROCESSES, coordinator_configured, parse_mesh

    if args.mesh and coordinator_configured():
        parser.error(f"--mesh {args.mesh}: {SERVE_ACROSS_PROCESSES}")
    try:
        mesh = parse_mesh(args.mesh, args.device)
    except (NotImplementedError, ValueError) as e:
        parser.error(f"--mesh {args.mesh}: {e}")

    from ugpg_tpu_torch.eval.http_server import ServingHTTPServer

    registry = build_registry(args, mesh)
    server = ServingHTTPServer(registry, host=args.host, port=args.port, verbose=args.verbose)
    print(f"serving {registry.names()} on http://{server.host}:{server.port} (Ctrl-C to stop)",
          flush=True)
    try:
        server.serve_forever()
    finally:
        registry.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
