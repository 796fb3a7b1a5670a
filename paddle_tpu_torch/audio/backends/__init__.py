"""paddle.audio.backends analog: counterpart of
``paddle_tpu/audio/backends/__init__.py`` (reference: python/paddle/audio/
backends — wave_backend.py default, soundfile when installed).

Dependency-free WAV I/O via the stdlib `wave` module (the reference's
default backend does exactly this); soundfile is used when available."""
from __future__ import annotations

import wave as _wave

import numpy as np

from ...core.tensor import Tensor

__all__ = ["list_available_backends", "get_current_backend", "set_backend",
           "load", "save", "info"]

_BACKEND = "wave_backend"


def list_available_backends():
    out = ["wave_backend"]
    try:
        import soundfile  # noqa: F401
        out.append("soundfile")
    except ImportError:
        pass
    return out


def get_current_backend():
    return _BACKEND


def set_backend(backend_name):
    global _BACKEND
    if backend_name not in list_available_backends():
        raise ValueError(f"backend {backend_name!r} not available "
                         f"(have {list_available_backends()})")
    _BACKEND = backend_name


class AudioInfo:
    def __init__(self, sample_rate, num_samples, num_channels,
                 bits_per_sample, encoding):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def info(filepath):
    """reference: wave_backend.py info."""
    with _wave.open(filepath, "rb") as f:
        return AudioInfo(f.getframerate(), f.getnframes(), f.getnchannels(),
                         f.getsampwidth() * 8, "PCM_S")


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """WAV -> (Tensor [C, N] or [N, C], sample_rate)
    (reference: wave_backend.py load)."""
    with _wave.open(filepath, "rb") as f:
        sr, ch, width = f.getframerate(), f.getnchannels(), f.getsampwidth()
        f.setpos(frame_offset)
        n = f.getnframes() - frame_offset if num_frames < 0 else num_frames
        raw = f.readframes(n)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    a = np.frombuffer(raw, dtype=dt).reshape(-1, ch)
    if width == 1:
        a = a.astype(np.float32) / 128.0 - 1.0 if normalize else a
    elif normalize:
        a = a.astype(np.float32) / float(2 ** (8 * width - 1))
    out = a.T if channels_first else a
    return Tensor(out), sr


def save(filepath, src, sample_rate, channels_first=True,
         encoding="PCM_16", bits_per_sample=16):
    """Tensor -> PCM WAV at 8/16/32 bits (reference: wave_backend.py save)."""
    if bits_per_sample not in (8, 16, 32):
        raise ValueError(f"bits_per_sample must be 8/16/32, got "
                         f"{bits_per_sample}")
    a = np.asarray(src.numpy() if isinstance(src, Tensor) else src)
    if channels_first:
        a = a.T
    store = {8: np.uint8, 16: np.int16, 32: np.int32}[bits_per_sample]
    if a.dtype.kind == "f":
        a = np.clip(a, -1.0, 1.0)
        if bits_per_sample == 8:          # WAV 8-bit is unsigned, midpoint 128
            a = ((a + 1.0) * 127.5).astype(store)
        else:
            a = (a * (2 ** (bits_per_sample - 1) - 1)).astype(store)
    else:
        a = a.astype(store)               # integer src: width conversion
    with _wave.open(filepath, "wb") as f:
        f.setnchannels(a.shape[1] if a.ndim == 2 else 1)
        f.setsampwidth(bits_per_sample // 8)
        f.setframerate(int(sample_rate))
        f.writeframes(a.tobytes())
