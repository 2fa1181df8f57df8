"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles at first use, with ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface under
``ugpg_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
its sources and flags, so an edited source rebuilds.  ``build()`` starts
one ``nvcc`` per missing library, all at once.  The libraries are bound
with ``ctypes``: every pointer and the stream travel as ``c_void_p``.

Every C entry launches on the stream it is given, allocates nothing,
does not synchronise, and returns ``cudaGetLastError()``; ``check``
raises on anything but 0.  Each wrapper counts its launches here
(``count``), so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "SOURCES",
    "build",
    "function",
    "check",
    "dtype_code",
    "stream",
    "on_device",
    "count",
    "launch_counts",
    "reset_launch_counts",
]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("uncertainty", "upsample2x", "double_conv", "uncertainty_bce")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_launches: dict[str, int] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together; raise ``RuntimeError`` with the
    compiler's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.ugpg_error_string.argtypes = [ctypes.c_int]
        lib.ugpg_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def function(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<source>.cu``, built and bound on
    first use, returning an ``int`` CUDA error code."""
    key = (source, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            fn = getattr(_library(source), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
    return fn


def check(rc: int, source: str, what: str) -> None:
    """Raise when a C entry reports a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if rc != 0:
        msg = _library(source).ugpg_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType


def dtype_code(t: torch.Tensor, what: str) -> int:
    """The kernels' dtype code of ``t``; raise on a dtype they do not take."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: float32 or bfloat16 expected, got {t.dtype}")
    return code


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer.  The raw
    lookup skips building a ``torch.cuda.Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(fn, device: torch.device, *args) -> int:
    """``fn(*args)`` with ``device`` current, entering its context only
    when another device is current."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def count(kernel: str) -> None:
    with _lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()
