"""ctypes bindings for the port's host C++: the polygon rasterizers, the
PNG, TIFF and BMP decoders (copies of ``rasterize.cpp``, ``png_decode.cpp``,
``tiff_decode.cpp`` and ``bmp_decode.cpp`` of the JAX package, the
rasterizer extended with Pillow's polygon fill), Pillow's Gaussian blur
(``gaussian_blur.cpp``, for the offline augmentation) and zstd frames and
CRC-32C for orbax checkpoints (``zstd.cpp``, linked to the system's
``libzstd.so.1``).

Each source compiles at first use with ``g++`` into its own shared library
under ``ugpg_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source rebuilds; a lock keeps
threads from building one library twice, and a finished build is moved into
place atomically.  A failed build raises ``RuntimeError`` with the
compiler's output, and a file outside a decoder's profile raises
``ValueError`` naming the file and what the decoder lacks: there is no other
path to fall back on.  ctypes releases the GIL for every call, so the
threaded ``DataLoader`` decodes and rasterizes in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "build",
    "rasterize_polygons_pil",
    "rasterize_polygons_native",
    "decode_png",
    "decode_png_gray",
    "decode_tiff",
    "decode_bmp",
    "image_hw",
    "gaussian_blur",
    "zstd_compress",
    "zstd_decompress",
    "crc32c",
]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
# -ffp-contract=off: the Pillow fill must round where Pillow rounds, never
# fuse a multiply and an add
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LDFLAGS = {"rasterize": ("-lpthread",), "png_decode": ("-lz",), "tiff_decode": ("-lz",),
            "bmp_decode": (), "gaussian_blur": (), "zstd": ("-l:libzstd.so.1",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_F64 = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "rasterize": {
        "rasterize_polygons_pil": [_P_F64, _P_I64, ctypes.c_int64, _P_U8, ctypes.c_int64,
                                   ctypes.c_int64],
        "rasterize_polygons": [_P_F64, _P_I64, ctypes.c_int64, _P_U8, ctypes.c_int64,
                               ctypes.c_int64],
    },
    "png_decode": {
        "png_info": [_P_U8, ctypes.c_int64, _P_I64, _P_I64, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_int)],
        "png_decode_rgb8": [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int64],
        "png_decode_gray8": [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int64],
    },
    "tiff_decode": {
        "tiff_info": [_P_U8, ctypes.c_int64, _P_I64, _P_I64, ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)],
        "tiff_decode_rgb8": [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int64],
    },
    "bmp_decode": {
        "bmp_info": [_P_U8, ctypes.c_int64, _P_I64, _P_I64, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_int)],
        "bmp_decode_rgb8": [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int64],
    },
    "gaussian_blur": {
        "gaussian_blur_rgb8": [_P_U8, _P_U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                               ctypes.c_float, ctypes.c_int],
    },
    "zstd": {
        "zstd_version": [],
        "zstd_compress_bound": [ctypes.c_int64],
        "zstd_compress": [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int64, ctypes.c_int],
        "zstd_content_size": [_P_U8, ctypes.c_int64],
        "zstd_decompress": [_P_U8, ctypes.c_int64, _P_U8, ctypes.c_int64, _P_I64],
        "crc32c": [_P_U8, ctypes.c_int64, ctypes.c_uint32],
    },
}
# return types other than the decoders' int status
_RESTYPES = {"zstd_compress_bound": ctypes.c_int64, "zstd_compress": ctypes.c_int64,
             "zstd_content_size": ctypes.c_int64, "crc32c": ctypes.c_uint32}


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + _LDFLAGS[name]).encode())
    h.update((_HERE / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(_SIGNATURES)) -> None:
    """Compile every library of ``names`` that is not built yet, one ``g++``
    each, all started together; raise ``RuntimeError`` with the compiler's
    output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_HERE / f"{name}.cpp"), *_LDFLAGS[name]]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        except OSError as e:
            raise RuntimeError(f"g++ could not start for {name}.cpp: {e}") from e
        jobs[name] = (proc, tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cpp (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("g++ failed for " + "\n".join(failed))


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = (None if name == "rasterize"
                              else _RESTYPES.get(symbol, ctypes.c_int))
            _libs[name] = lib
        return lib


# ---------------------------------------------------------------- rasterizers
def _pack(polygons):
    if polygons:
        vertices = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for p in polygons])
    else:
        vertices = np.zeros((0, 2), np.float64)
    offsets = np.zeros(len(polygons) + 1, np.int64)
    offsets[1:] = np.cumsum([len(p) for p in polygons])
    return np.ascontiguousarray(vertices), offsets


def _rasterize(symbol: str, polygons, image_hw) -> np.ndarray:
    h, w = image_hw
    vertices, offsets = _pack(polygons)
    mask = np.zeros((h, w), np.uint8)
    getattr(_library("rasterize"), symbol)(
        vertices.ctypes.data_as(_P_F64), offsets.ctypes.data_as(_P_I64), len(polygons),
        mask.ctypes.data_as(_P_U8), h, w)
    return mask


def rasterize_polygons_pil(polygons, image_hw) -> np.ndarray:
    """Pillow's filled polygon (``ImageDraw.polygon(xy, fill=1)``, no
    outline, on an "L" image), bit for bit: (H, W) uint8 {0, 1}."""
    return _rasterize("rasterize_polygons_pil", polygons, image_hw)


def rasterize_polygons_native(polygons, image_hw) -> np.ndarray:
    """The even-odd scanline fill of the JAX package's native backend."""
    return _rasterize("rasterize_polygons", polygons, image_hw)


# ---------------------------------------------------------------- decoders
# each decoder: (library, C entry, PNG color type, output channels), and what
# it reads; the rest of either format raises
_DECODERS = {
    "png": ("png_decode", "png_decode_rgb8", 2, 3),
    "png_gray": ("png_decode", "png_decode_gray8", 0, 1),
    "tiff": ("tiff_decode", "tiff_decode_rgb8", None, 3),
    "bmp": ("bmp_decode", "bmp_decode_rgb8", None, 3),
}
_PROFILES = {
    "png": "8-bit RGB (color type 2), non-interlaced PNG",
    "png_gray": "8-bit gray (color type 0), non-interlaced PNG",
    "tiff": ("classic TIFF, first IFD, strips, chunky 8-bit gray/RGB/RGBA, compression "
             "none/LZW (predictor 1 or 2)/Deflate/PackBits, either byte order"),
    "bmp": ("'BM' with a BITMAPINFOHEADER or larger, 24- or 32-bit uncompressed BI_RGB, "
            "bottom-up or top-down"),
}
_ERRORS = {-1: "not this format (bad signature)", -2: "truncated", -3: "outside the profile",
           -4: "corrupt compressed data", -5: "bad PNG row filter", -6: "buffer too small"}


def _read(source) -> tuple[bytes, str]:
    if isinstance(source, (str, os.PathLike)):
        return Path(source).read_bytes(), str(source)
    return bytes(source), "<bytes>"


def _info(kind: str, data: bytes, label: str):
    name, _, color_type, _ = _DECODERS[kind]
    lib = _library(name)
    buf = np.frombuffer(data, np.uint8)
    ptr = buf.ctypes.data_as(_P_U8)
    h, w, a, b = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    info = getattr(lib, name.replace("_decode", "_info"))
    rc = info(ptr, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(a), ctypes.byref(b))
    if rc != 0:
        raise ValueError(f"{label}: {_ERRORS.get(rc, f'error {rc}')}; the decoder reads "
                         f"{_PROFILES[kind]}")
    if color_type is not None and (a.value, b.value) != (color_type, 8):
        raise ValueError(f"{label}: PNG color type {a.value}, bit depth {b.value}; the decoder "
                         f"reads {_PROFILES[kind]}")
    return buf, ptr, h.value, w.value


def _decode(kind: str, source) -> np.ndarray:
    data, label = _read(source)
    buf, ptr, h, w = _info(kind, data, label)
    name, entry, _, channels = _DECODERS[kind]
    out = np.empty((h, w, 3) if channels == 3 else (h, w), np.uint8)
    rc = getattr(_library(name), entry)(ptr, len(data), out.ctypes.data_as(_P_U8), out.size)
    if rc != 0:
        raise ValueError(f"{label}: {_ERRORS.get(rc, f'error {rc}')}; the decoder reads "
                         f"{_PROFILES[kind]}")
    return out


def decode_png(source) -> np.ndarray:
    """An 8-bit RGB non-interlaced PNG (a path or bytes) -> (H, W, 3)
    uint8; any other PNG raises ``ValueError``."""
    return _decode("png", source)


def decode_png_gray(source) -> np.ndarray:
    """An 8-bit gray (color type 0) non-interlaced PNG (a path or bytes),
    as ``io/png.py`` writes masks, -> (H, W) uint8; any other PNG raises
    ``ValueError``."""
    return _decode("png_gray", source)


def decode_tiff(source) -> np.ndarray:
    """A TIFF of the profile above (a path or bytes) -> (H, W, 3) uint8 RGB
    (gray replicated, alpha dropped); any other TIFF raises ``ValueError``."""
    return _decode("tiff", source)


def decode_bmp(source) -> np.ndarray:
    """A BMP of the profile above (a path or bytes) -> (H, W, 3) uint8 RGB
    (rows in top-down order, alpha dropped); any other BMP raises
    ``ValueError``."""
    return _decode("bmp", source)


def image_hw(path) -> tuple[int, int]:
    """(H, W) of a PNG, BMP or TIFF from its header, without decoding."""
    data, label = _read(path)
    low = label.lower()
    kind = "png" if low.endswith(".png") else "bmp" if low.endswith(".bmp") else "tiff"
    _, _, h, w = _info(kind, data, label)
    return h, w


# ---------------------------------------------------------------- filters
def gaussian_blur(image: np.ndarray, radius: float) -> np.ndarray:
    """Pillow's ``image.filter(ImageFilter.GaussianBlur(radius))`` on an
    (H, W, 3) uint8 RGB array, bit for bit (``radius`` is the Gaussian's
    sigma, taken as a C float as Pillow takes it; Pillow's three box
    passes): (H, W, 3) uint8."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"gaussian_blur: (H, W, 3) uint8 expected, got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    out = np.empty_like(image)
    rc = _library("gaussian_blur").gaussian_blur_rgb8(
        image.ctypes.data_as(_P_U8), out.ctypes.data_as(_P_U8), h, w, radius, radius, 3)
    if rc != 0:
        raise ValueError(f"gaussian_blur: radius {radius} out of range, or an empty image")
    return out


# ---------------------------------------------------------------- zstd, CRC-32C
def _bytes_view(data) -> np.ndarray:
    """A uint8 view of any bytes-like object (no copy)."""
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def zstd_compress(data, level: int = 1) -> np.ndarray:
    """One zstd frame of ``data`` (bytes-like) at ``level``, with its
    content size: a uint8 array."""
    lib = _library("zstd")
    src = _bytes_view(data)
    out = np.empty(lib.zstd_compress_bound(src.size), np.uint8)
    n = lib.zstd_compress(out.ctypes.data_as(_P_U8), out.size, src.ctypes.data_as(_P_U8),
                          src.size, level)
    if n < 0:
        raise ValueError(f"zstd: level {level} refused")
    return out[:n]


def zstd_decompress(data, size: int | None = None) -> np.ndarray:
    """Every zstd frame of ``data`` (bytes-like), decoded: a uint8 array.
    With ``size``, the frames must decode to exactly that many bytes;
    without it, to the first frame's declared content size, or to however
    many they hold.  Corrupt frames raise ``ValueError``."""
    lib = _library("zstd")
    src = _bytes_view(data)
    ptr = src.ctypes.data_as(_P_U8)
    if size is None:
        declared = lib.zstd_content_size(ptr, src.size)
        if declared == -2:
            raise ValueError("zstd: not a zstd frame")
        cap = declared if declared >= 0 else max(4 * src.size, 1 << 16)
    else:
        cap = size
    written = ctypes.c_int64()
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.zstd_decompress(out.ctypes.data_as(_P_U8), cap, ptr, src.size,
                                 ctypes.byref(written))
        if rc == 1 and size is None:
            cap *= 2
            continue
        if rc != 0:
            raise ValueError("zstd: corrupt frame" if rc < 0 else
                             f"zstd: the frames hold more than the {size} bytes expected")
        if size is not None and written.value != size:
            raise ValueError(f"zstd: the frames hold {written.value} bytes, {size} expected")
        return out[:written.value]


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data`` (bytes-like), continuing ``crc``."""
    src = _bytes_view(data)
    return _library("zstd").crc32c(src.ctypes.data_as(_P_U8), src.size, crc)
