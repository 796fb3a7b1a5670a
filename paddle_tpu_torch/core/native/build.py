"""Lazy native-code builder: compile a .cc beside this package into a cached
.so and load it via ctypes (reference equivalent: the paddle build links
phi's C++ runtime; here native pieces compile on first use and every caller
has a pure-Python fallback, so a missing toolchain never breaks the wheel).

Cache: ``build/paddle_tpu_torch/native/<name>-<hash>.so`` beside the package
(the CUDA kernels' ``build/paddle_tpu_torch/`` tree), keyed by the source's
hash, so nothing is written outside the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_lock = threading.Lock()
_loaded: dict = {}     # (name, source digest) -> CDLL | None
_errors: dict = {}     # name -> last failure diagnostic


def last_error(name: str):
    """Diagnostic from the most recent failed load() of `name`."""
    return _errors.get(name)


def _cache_dir():
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(os.path.dirname(pkg), "build", "paddle_tpu_torch",
                        "native")


def load(name: str, source_file: str, extra_flags=()):
    """Compile+load <dir of build.py>/<source_file> as a shared lib.
    Returns ctypes.CDLL, or None when no toolchain / compile error
    (callers fall back to their Python implementation)."""
    with _lock:
        src = source_file if os.path.isabs(source_file) else \
            os.path.join(os.path.dirname(__file__), source_file)
        try:
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
        except OSError as e:
            _errors[name] = f"cannot read {src}: {e}"
            return None
        # memo keyed by content digest: fixing the source and re-calling
        # load() in the same process retries instead of replaying a failure
        memo = (name, digest)
        if memo in _loaded:
            return _loaded[memo]
        out = os.path.join(_cache_dir(), f"{name}-{digest}.so")
        if not os.path.exists(out):
            os.makedirs(_cache_dir(), exist_ok=True)
            # a temporary of this process's own: processes that build the
            # same library at once (test workers, a fresh checkout's first
            # users) each rename a whole one into place
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                   "-pthread", src, "-o", tmp, *extra_flags]
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=120)
                if r.returncode != 0:
                    _errors[name] = r.stderr.decode(errors="replace")[-4000:]
                    _loaded[memo] = None
                    return None
            except (OSError, subprocess.TimeoutExpired) as e:
                _errors[name] = f"g++ unavailable or timed out: {e}"
                _loaded[memo] = None
                return None
            os.replace(tmp, out)
        try:
            _loaded[memo] = ctypes.CDLL(out)
        except OSError as e:
            _errors[name] = f"dlopen failed: {e}"
            _loaded[memo] = None
        return _loaded[memo]
