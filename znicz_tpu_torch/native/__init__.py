"""The native image decode pool (port of ``znicz_tpu/native``).

:class:`ImagePipeline` wraps ``pipeline.cpp``, a copy of the JAX
package's worker pool: JPEG and PNG decode, bilinear resize, crop, flip
and affine normalize, writing float32 or raw uint8 NHWC minibatches, one
batch in flight per pool.  Its decoders are the package's own
(``jpeg_decode.cpp``, ``png_decode.cpp``): they give the bytes the JAX
package's pool gets from libjpeg-turbo and libpng, and link only zlib,
so the pool builds wherever g++ and zlib are, the card's machine
included.  It is compiled on first use with ``g++ -O3 -march=native``
into ``build/znicz_tpu_torch/native/`` at the root of the checkout
(beside the CUDA kernels' libraries) and loaded with ``ctypes``.  The
library's name is a hash of every source it is built from and of the
host's CPU flags (``-march=native``: a machine builds its own), and each
process compiles into a file of its own before renaming it into place,
so concurrent first uses do not interleave.  Nothing is built at import.

``ImagePipeline.available()`` is False when the compiler or zlib is
missing; :meth:`ImagePipeline.build_error` says why.  The image loaders
decide what that means (:mod:`znicz_tpu_torch.loader.image`): PIL on the
CPU, an error on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
#: the sources compiled into the one library, then the header they share
SOURCES = (_DIR / "pipeline.cpp", _DIR / "jpeg_decode.cpp",
           _DIR / "png_decode.cpp")
_HEADERS = (_DIR / "image_decode.h",)
BUILD_DIR = _DIR.parent.parent / "build" / "znicz_tpu_torch" / "native"
_LIBS = ("-lz",)

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_build_error: str | None = None


def library_path() -> Path:
    """Where the library for these sources and this host's CPU goes: a
    change to any source or header gives another name."""
    h = hashlib.sha256()
    for src in (*SOURCES, *_HEADERS):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    h.update(line.encode())
                    break
    except OSError:
        import platform
        h.update(platform.processor().encode())
    return BUILD_DIR / f"znicz_pipeline_{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    """Compile the library once per source and host, and load it."""
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", *map(str, SOURCES), "-o", tmp, "-pthread",
               *_LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(f"native build failed: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.zp_create.restype = ctypes.c_void_p
    lib.zp_create.argtypes = [ctypes.c_int]
    lib.zp_destroy.restype = None
    lib.zp_destroy.argtypes = [ctypes.c_void_p]
    lib.zp_submit.restype = ctypes.c_int
    lib.zp_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int]
    lib.zp_wait.restype = ctypes.c_int
    lib.zp_wait.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> "ctypes.CDLL | None":
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build()
            except (RuntimeError, OSError) as exc:  # no compiler or zlib
                _build_error = str(exc)
        return _lib


class ImagePipeline:
    """Asynchronous decode and augment of one batch at a time::

        pipe = ImagePipeline(n_threads=8)
        pipe.submit(paths, out, out_hw=(227, 227), resize_hw=(256, 256),
                    random_crop=True, random_flip=True, seed=step)
        ...                      # the device works on the previous batch
        n_failed = pipe.wait()   # out is filled (a failed file: zeros)

    The constructor raises, carrying the build error, when the library
    cannot be built.
    """

    def __init__(self, n_threads: int = 0) -> None:
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native pipeline unavailable: "
                               f"{_build_error}")
        self._lib = lib
        self._pool = lib.zp_create(int(n_threads))
        self._keepalive: tuple | None = None  # paths array + out buffer

    @staticmethod
    def available() -> bool:
        return _get_lib() is not None

    @staticmethod
    def build_error() -> str | None:
        _get_lib()
        return _build_error

    def submit(self, paths: list[str], out: np.ndarray,
               out_hw: tuple[int, int],
               resize_hw: tuple[int, int] | None = None,
               channels: int = 3, random_crop: bool = False,
               random_flip: bool = False, scale: float = 1.0,
               bias: float = 0.0, seed: int = 0) -> None:
        if self._pool is None:
            raise RuntimeError("pipeline destroyed")
        n = len(paths)
        out_h, out_w = out_hw
        expected = (n, out_h, out_w, channels) if channels == 3 \
            else (n, out_h, out_w)
        if out.dtype not in (np.float32, np.uint8) \
                or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous float32 or uint8")
        out_u8 = out.dtype == np.uint8
        if out_u8 and (scale != 1.0 or bias != 0.0):
            raise ValueError("uint8 output is raw pixels — normalize "
                             "on the device (scale/bias must be 1/0)")
        if out.size != n * out_h * out_w * channels:
            raise ValueError(f"out size {out.shape} != {expected}")
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rh, rw = resize_hw if resize_hw is not None else (0, 0)
        rc = self._lib.zp_submit(
            self._pool, arr, n, rh, rw, out_h, out_w, channels,
            int(random_crop), int(random_flip),
            ctypes.c_float(scale), ctypes.c_float(bias),
            ctypes.c_uint64(seed & (2 ** 64 - 1)),
            ctypes.c_void_p(out.ctypes.data), ctypes.c_int(out_u8))
        if rc != 0:
            raise RuntimeError(f"zp_submit failed (rc={rc})")
        # the paths array and the buffer outlive the asynchronous batch
        self._keepalive = (arr, out)

    def wait(self) -> int:
        """Block until the batch in flight is done; the number of files
        that failed to decode (their rows are zeros)."""
        if self._pool is None:
            raise RuntimeError("pipeline destroyed")
        n_failed = self._lib.zp_wait(self._pool)
        self._keepalive = None
        return int(n_failed)

    def close(self) -> None:
        if self._pool is not None:
            self._lib.zp_wait(self._pool)
            self._lib.zp_destroy(self._pool)
            self._pool = None

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


__all__ = ["ImagePipeline", "BUILD_DIR", "SOURCES", "library_path"]
