"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so
a build takes seconds).  Libraries land in ``build/paddle_tpu_torch/`` beside
the package, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  A file lock per source
keeps two processes from building the same library at the same time.

Nothing builds at import: :func:`load` compiles on first use, and
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "build_all", "sources", "BuildError"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "paddle_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}        # name -> loaded ctypes.CDLL
LOGS: dict = {}         # name -> nvcc's stderr (ptxas register/smem report)


class BuildError(RuntimeError):
    """nvcc failed; the message carries its stderr."""


def sources():
    """Names of the kernels under ``csrc/`` (one library each)."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                     "default /usr/local/cuda/bin)")


def _target(name):
    src = _CSRC / f"{name}.cu"
    if not src.exists():
        raise BuildError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return src, _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name):
    """Start nvcc for ``name`` unless its library is already built; returns
    (src, so, lock file, process or None).  The lock is held until
    :func:`_finish` releases it."""
    src, so = _target(name)
    _BUILD.mkdir(parents=True, exist_ok=True)
    lock = open(_BUILD / f"{name}.lock", "w")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return src, so, lock, None
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except BaseException:
        lock.close()
        raise
    return src, so, lock, proc


def _finish(name, so, lock, proc):
    try:
        if proc is not None:
            out, err = proc.communicate()
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                if tmp.exists():
                    tmp.unlink()
                raise BuildError(f"nvcc failed for {name} "
                                 f"(rc {proc.returncode}):\n{out}{err}")
            os.replace(tmp, so)
            LOGS[name] = err
        _LIBS[name] = ctypes.CDLL(str(so))
    finally:
        lock.close()
    return _LIBS[name]


def load(name):
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, so, lock, proc = _start(name)
        lib = _finish(name, so, lock, proc)
    return lib


def build_all():
    """Build every kernel under ``csrc/`` with one nvcc each, all started
    together; returns the wall seconds it took.  Raises on the first
    failed build, after every started nvcc has been waited for."""
    t0 = time.perf_counter()
    started, first_err = [], None
    try:
        for name in sources():
            if name not in _LIBS:
                _, so, lock, proc = _start(name)
                started.append((name, so, lock, proc))
    finally:
        for name, so, lock, proc in started:
            try:
                _finish(name, so, lock, proc)
            except BuildError as e:
                first_err = first_err or e
    if first_err is not None:
        raise first_err
    return time.perf_counter() - t0
