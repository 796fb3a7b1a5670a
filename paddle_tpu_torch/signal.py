"""paddle.signal analog — STFT / ISTFT: counterpart of
``paddle_tpu/signal.py`` (reference: python/paddle/signal.py over phi
frame / overlap_add kernels).  Framing is a strided view
(``Tensor.unfold``); the centring pad is a gather, so it takes any rank
and dtype as ``jnp.pad`` does; overlap-add is ``index_add`` over the flat
frame positions.  On the card ``index_add`` adds with atomics, so the
order of the overlapping sums is not fixed: results there agree with the
CPU's to rounding, not bitwise.
"""
from __future__ import annotations

import math

import torch

from .core.dispatch import apply_op
from .core.tensor import Tensor

__all__ = ["stft", "istft", "frame", "overlap_add"]


def _pad_last(a, p, mode):
    """``jnp.pad(a, [(0, 0)] * (ndim - 1) + [(p, p)], mode=mode)`` for
    ``stft``'s two modes; reflect is a gather, so it takes any rank and
    dtype."""
    if mode == "constant":
        return torch.nn.functional.pad(a, (p, p))
    if mode != "reflect":
        raise ValueError(f"pad_mode must be 'reflect' or 'constant', got "
                         f"{mode!r}")
    n = a.shape[-1]
    i = torch.remainder(torch.arange(-p, n + p, device=a.device),
                        2 * (n - 1))
    return a[..., torch.where(i >= n, 2 * (n - 1) - i, i)]


def _flat_positions(nf, hop, fl, device):
    """Output position of each element of [nf, fl] frames, flattened."""
    starts = torch.arange(nf, device=device) * hop
    return (starts[:, None] + torch.arange(fl, device=device)[None, :]) \
        .reshape(-1)


def _overlap(frames, hop):
    """frames [..., nf, fl] overlap-added into [..., (nf - 1) * hop + fl]."""
    nf, fl = frames.shape[-2], frames.shape[-1]
    n = (nf - 1) * hop + fl
    idx = _flat_positions(nf, hop, fl, frames.device)
    flat = frames.reshape(frames.shape[:-2] + (nf * fl,))
    out = torch.zeros(frames.shape[:-2] + (n,), dtype=flat.dtype,
                      device=flat.device)
    return torch.index_add(out, -1, idx, flat)


def _window(rest, win_length, n_fft, device):
    win = rest[0] if rest else torch.ones(win_length, dtype=torch.float32,
                                          device=device)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (lp, n_fft - win_length - lp))
    return win


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice x into overlapping frames along `axis` (reference signal.frame)."""
    def f(a):
        moved = torch.movedim(a, axis, -1)
        framed = moved.unfold(-1, frame_length, hop_length)  # [.., nf, fl]
        if axis in (-1, a.ndim - 1):
            return framed.transpose(-1, -2)              # [.., fl, nf]
        return torch.movedim(framed, (-2, -1), (axis, axis + 1))
    return apply_op("frame", f, x)


def overlap_add(x, hop_length, axis=-1, name=None):
    """Reconstruct from frames by overlap-adding (reference signal.overlap_add).
    x: [..., frame_length, n_frames] when axis=-1."""
    def f(a):
        if axis in (-1, a.ndim - 1):
            frames = a.transpose(-1, -2)                 # [.., nf, fl]
        else:
            frames = torch.movedim(a, (axis, axis + 1), (-2, -1))
        return _overlap(frames, hop_length)
    return apply_op("overlap_add", f, x)


def stft(x, n_fft, hop_length=None, win_length=None, window=None, center=True,
         pad_mode="reflect", normalized=False, onesided=True, name=None):
    """Short-time Fourier transform (reference python/paddle/signal.py:stft).
    x: [batch, n] or [n] real (or complex with onesided=False).
    Returns [batch, n_fft//2+1 | n_fft, n_frames] complex."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def f(a, *rest):
        win = _window(rest, win_length, n_fft, a.device)
        if center:
            a = _pad_last(a, n_fft // 2, pad_mode)
        frames = a.unfold(-1, n_fft, hop_length) * win   # [.., nf, n_fft]
        if onesided and not frames.is_complex():
            spec = torch.fft.rfft(frames, dim=-1)
        else:
            spec = torch.fft.fft(frames, dim=-1)
        if normalized:
            spec = spec / math.sqrt(n_fft)
        return spec.transpose(-1, -2)                    # [.., freq, nf]

    args = (x, window) if isinstance(window, Tensor) else (x,)
    return apply_op("stft", f, *args)


def istft(x, n_fft, hop_length=None, win_length=None, window=None, center=True,
          normalized=False, onesided=True, length=None, return_complex=False,
          name=None):
    """Inverse STFT with windowed overlap-add + window-envelope normalization
    (reference signal.istft)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def f(a, *rest):
        win = _window(rest, win_length, n_fft, a.device)
        spec = a.transpose(-1, -2)                       # [.., nf, freq]
        if normalized:
            spec = spec * math.sqrt(n_fft)
        if onesided:
            frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
        else:
            frames = torch.fft.ifft(spec, dim=-1)
            if not return_complex:
                frames = frames.real
        frames = frames * win
        nf = frames.shape[-2]
        out = _overlap(frames, hop_length)
        n = out.shape[-1]
        # window envelope for COLA normalization
        env = _overlap((win * win).expand(nf, n_fft), hop_length)
        out = out / torch.where(env > 1e-11, env, 1.0)
        if center:
            out = out[..., n_fft // 2: n - n_fft // 2]
        if length is not None:
            out = out[..., :length]
        return out

    args = (x, window) if isinstance(window, Tensor) else (x,)
    return apply_op("istft", f, *args)
