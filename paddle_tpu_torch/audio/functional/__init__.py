"""paddle.audio.functional analog: counterpart of
``paddle_tpu/audio/functional/__init__.py`` (reference: python/paddle/audio/
functional/functional.py + window.py).

Everything is float32 torch math producing framework Tensors on the current
place; the fbank / DCT matrices are built once (tiny) and the per-batch
feature pipeline (stft -> |.|^2 -> fbank matmul -> log) runs on the card.
Windows are built in numpy float64, as in the reference, then moved."""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Tensor
from ...core.dispatch import unwrap
from ...core.device import current_device
from ...core.dtype import convert_dtype

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "power_to_db", "create_dct", "get_window"]


def _f32(x):
    """A float32 torch tensor of x (a Tensor's buffer stays where it is)."""
    if isinstance(x, Tensor):
        x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=current_device())


def hz_to_mel(freq, htk=False):
    """reference: functional.py:29."""
    f = _f32(freq)
    if htk:
        out = 2595.0 * torch.log10(1.0 + f / 700.0)
        return Tensor(out) if isinstance(freq, Tensor) else float(out)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    mels = torch.where(f >= min_log_hz,
                       min_log_mel + torch.log(torch.clamp(f, min=1e-10)
                                               / min_log_hz) / logstep, mels)
    return Tensor(mels) if isinstance(freq, Tensor) else float(mels)


def mel_to_hz(mel, htk=False):
    """reference: functional.py:83."""
    m = _f32(mel)
    if htk:
        out = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
        return Tensor(out) if isinstance(mel, Tensor) else float(out)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    freqs = torch.where(m >= min_log_mel,
                        min_log_hz * torch.exp(logstep * (m - min_log_mel)),
                        freqs)
    return Tensor(freqs) if isinstance(mel, Tensor) else float(freqs)


def _linspace(lo, hi, n):
    """``jnp.linspace`` in float32, its formula: ``lo * (1 - t) + hi * t``
    at ``t = i / (n - 1)``, the last point exactly ``hi``."""
    dev = current_device()
    t = torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1)
    lo_t, hi_t = (torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in (lo, hi))
    return torch.cat([lo_t * (1 - t) + hi_t * t, hi_t[None]])


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32"):
    """reference: functional.py:126."""
    lo = hz_to_mel(f_min, htk)
    hi = hz_to_mel(f_max, htk)
    mels = _linspace(lo, hi, n_mels)
    return Tensor(unwrap(mel_to_hz(Tensor(mels), htk))
                  .to(convert_dtype(dtype)))


def fft_frequencies(sr, n_fft, dtype="float32"):
    """reference: functional.py:166."""
    return Tensor(_linspace(0, sr / 2, 1 + n_fft // 2)
                  .to(convert_dtype(dtype)))


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32"):
    """Triangular mel filterbank [n_mels, 1 + n_fft//2]
    (reference: functional.py:189)."""
    if f_max is None:
        f_max = sr / 2.0
    fftfreqs = unwrap(fft_frequencies(sr, n_fft))
    melfreqs = unwrap(mel_frequencies(n_mels + 2, f_min, f_max, htk))
    fdiff = torch.diff(melfreqs)
    ramps = melfreqs[:, None] - fftfreqs[None, :]   # [n_mels+2, n_bins]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.clamp(torch.minimum(lower, upper), min=0)
    if norm == "slaney":
        enorm = 2.0 / (melfreqs[2:n_mels + 2] - melfreqs[:n_mels])
        weights = weights * enorm[:, None]
    return Tensor(weights.to(convert_dtype(dtype)))


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """10*log10(S/ref), clipped at top_db below the peak
    (reference: functional.py:262)."""
    s = _f32(spect)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return Tensor(log_spec) if isinstance(spect, Tensor) else log_spec


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32"):
    """DCT-II matrix [n_mels, n_mfcc] (reference: functional.py:306)."""
    dev = current_device()
    n = torch.arange(n_mels, dtype=torch.float32, device=dev)
    k = torch.arange(n_mfcc, dtype=torch.float32, device=dev)[None, :]
    dct = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k) * 2.0
    if norm == "ortho":
        dct[:, 0] *= math.sqrt(1.0 / (4 * n_mels))
        dct[:, 1:] *= math.sqrt(1.0 / (2 * n_mels))
    return Tensor(dct.to(convert_dtype(dtype)))


# ---- windows (reference: window.py get_window) -------------------------------
def _extend(M, sym):
    return (M + 1, True) if not sym else (M, False)


def _truncate(w, trunc):
    return w[:-1] if trunc else w


def _window(name, M, sym, **kw):
    M1, trunc = _extend(M, sym)
    n = np.arange(M1)
    if M1 == 1:
        return np.ones(1)
    if name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (M1 - 1))
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (M1 - 1))
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / (M1 - 1))
             + 0.08 * np.cos(4 * np.pi * n / (M1 - 1)))
    elif name == "bartlett":
        w = 1.0 - np.abs(2 * n / (M1 - 1) - 1)
    elif name == "bohman":
        x = np.abs(2 * n / (M1 - 1) - 1)
        w = (1 - x) * np.cos(np.pi * x) + np.sin(np.pi * x) / np.pi
        w[0] = w[-1] = 0
    elif name == "nuttall":
        a = [0.3635819, 0.4891775, 0.1365995, 0.0106411]
        fac = 2 * np.pi * n / (M1 - 1)
        w = (a[0] - a[1] * np.cos(fac) + a[2] * np.cos(2 * fac)
             - a[3] * np.cos(3 * fac))
    elif name == "kaiser":
        beta = kw.get("beta", 12.0)
        w = np.i0(beta * np.sqrt(1 - (2 * n / (M1 - 1) - 1) ** 2)) / \
            np.i0(beta)
    elif name == "gaussian":
        std = kw.get("std", 7.0)
        w = np.exp(-0.5 * ((n - (M1 - 1) / 2) / std) ** 2)
    elif name == "general_gaussian":
        p, sig = kw.get("p", 1.5), kw.get("sig", 7.0)
        w = np.exp(-0.5 * np.abs((n - (M1 - 1) / 2) / sig) ** (2 * p))
    elif name == "exponential":
        tau = kw.get("tau", 1.0)
        w = np.exp(-np.abs(n - (M1 - 1) / 2) / tau)
    elif name == "triang":
        m = (M1 + 1) // 2
        up = np.arange(1, m + 1)
        if M1 % 2 == 0:
            ww = (2 * up - 1.0) / M1
            w = np.concatenate([ww, ww[::-1]])
        else:
            ww = 2 * up / (M1 + 1.0)
            w = np.concatenate([ww, ww[-2::-1]])
    elif name == "tukey":
        alpha = kw.get("alpha", 0.5)
        if alpha <= 0:
            w = np.ones(M1)
        elif alpha >= 1:
            w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (M1 - 1))
        else:
            width = int(alpha * (M1 - 1) / 2)
            w = np.ones(M1)
            edge = n[:width + 1]
            w[:width + 1] = 0.5 * (
                1 + np.cos(np.pi * (-1 + 2.0 * edge / alpha / (M1 - 1))))
            w[-(width + 1):] = w[:width + 1][::-1]
    else:
        raise ValueError(f"unknown window {name!r}")
    return _truncate(w, trunc)


def get_window(window, win_length, fftbins=True, dtype="float64"):
    """reference: window.py get_window — name or (name, param) tuple."""
    sym = not fftbins
    if isinstance(window, (list, tuple)):
        name, args = window[0], window[1:]
        param = {"kaiser": "beta", "gaussian": "std", "exponential": "tau",
                 "tukey": "alpha"}.get(name)
        kw = {param: args[0]} if (param and args) else {}
        if name == "general_gaussian" and len(args) >= 2:
            kw = {"p": args[0], "sig": args[1]}
        w = _window(name, win_length, sym, **kw)
    else:
        w = _window(window, win_length, sym)
    return Tensor(w.astype(dtype))
