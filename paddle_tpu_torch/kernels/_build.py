"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` on first
use — one ``nvcc`` per source, all started together — and the objects
link into one shared library with a plain C interface, loaded with
``ctypes``. The library lives in ``paddle_tpu_torch/_build/`` (ignored by
git) under a name keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when it is not 0. ``launch_counts`` holds one plain
integer per kernel, raised by the wrapper each time it launches.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset (wrappers add one per launch,
# through count_launch)
launch_counts: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
# seconds the last build took (0.0 when an up-to-date library was loaded)
build_seconds = None

_lib = None
_fns = {}


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``launch_counts``. Under a
    lock: a router's replicas launch from their own step threads, and a
    bare ``+= 1`` there can lose a count."""
    with _count_lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _sources(src_dir: Optional[Path] = None):
    return sorted(p for p in (src_dir or SRC_DIR).iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, src_dir: Optional[Path] = None) -> None:
    """Build the library ``out`` from the ``.cu`` sources in ``src_dir``
    (default ``SRC_DIR``; another tree's kernels, for a tool that times
    two trees side by side)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in (p for p in _sources(src_dir) if p.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for cmd, _obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
               *(str(obj) for _c, obj, _p in procs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(cmd)}\n"
                               f"{res.stdout.decode(errors='replace')}")
        os.replace(tmp_so, out)   # atomic: a reader never sees half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first when it is missing."""
    global _lib, build_seconds
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        so = BUILD_DIR / f"libptt_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        if not so.exists():
            _compile(so)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel(name: str, argtypes):
    """The C entry point ``name`` with its argument types declared."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err:
        msg = library().ptt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
