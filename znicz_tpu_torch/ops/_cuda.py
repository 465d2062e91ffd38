"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is a kernel with a plain C entry point.  On
first use every source is compiled by its own ``nvcc`` process, all
started together, into a shared library under
``build/znicz_tpu_torch/<hash>/`` at the root of the checkout, and
loaded with ``ctypes``.  The directory name is a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags, so an edited
kernel or header rebuilds and an unchanged one is reused.  Nothing
here runs at import: the tests import every module on machines
without ``nvcc``.

``nvcc`` is found through ``CUDA_HOME``, then ``/usr/local/cuda/bin``,
then ``PATH``; when none has it, :func:`library` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "znicz_tpu_torch"
#: one library per source; the kernel wrappers load them by stem
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "flash_attention_f32.cu", "flash_attention_bwd_f32.cu",
           "layer_norm_fwd.cu", "layer_norm_bwd.cu", "lrn.cu", "dropout.cu",
           "softmax_argmax.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``,
    then ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH) — the CUDA kernels "
                       "cannot be built")


def headers() -> tuple[str, ...]:
    """The headers the sources share (``csrc/*.cuh``), by name."""
    return tuple(sorted(p.name for p in CSRC.glob("*.cuh")))


def build_dir() -> Path:
    """The build directory for the current sources, headers and
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + headers():
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all running at once.  Returns stem → library path.  The
    compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside each library as ``<stem>.log``,
    ending with a line ``nvcc wall time <s> s``.  Raises with the
    compiler's output when any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {Path(name).stem: out_dir / f"lib{Path(name).stem}.so"
            for name in SOURCES}
    todo = {stem: lib for stem, lib in libs.items() if not lib.is_file()}
    if not todo:
        return libs
    nvcc = find_nvcc()
    procs = {}
    start = time.perf_counter()
    for stem, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(out_dir / f"{stem}.log", "w")
        procs[stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    running = dict(procs)
    while running:  # each build's wall time, from the common start
        for stem, (proc, _, log) in list(running.items()):
            if proc.poll() is not None:
                log.write(f"nvcc wall time "
                          f"{time.perf_counter() - start:.1f} s\n")
                del running[stem]
        time.sleep(0.05)
    failed = []
    for stem, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{stem}.cu (nvcc exit {rc}):\n"
                          + (out_dir / f"{stem}.log").read_text())
        else:
            os.replace(tmp, todo[stem])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def build_log(stem: str) -> str:
    """The compiler output kept for one kernel ('' when not built)."""
    path = build_dir() / f"{stem}.log"
    return path.read_text() if path.is_file() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<stem>.cu``, building every
    kernel on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no kernel source '{stem}.cu'")
            lib = _libs[stem] = ctypes.CDLL(str(paths[stem]))
        return lib
