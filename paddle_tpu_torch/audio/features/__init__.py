"""paddle.audio.features analog: counterpart of
``paddle_tpu/audio/features/__init__.py`` (reference: python/paddle/audio/
features/layers.py — Spectrogram, MelSpectrogram, LogMelSpectrogram, MFCC).

Each feature is a port ``Layer`` whose forward is stft -> power ->
(fbank matmul) -> (log / DCT), torch ops under ``apply_op`` (cuFFT and
cuBLAS on the card); the window, filterbank and DCT are registered
buffers."""
from __future__ import annotations

import torch

from ...core.tensor import Tensor
from ...core.dispatch import apply_op, unwrap
from ...core.dtype import convert_dtype
from ...nn.layer.layers import Layer
from ...signal import stft
from ..functional import (get_window, compute_fbank_matrix, power_to_db,
                          create_dct)

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    """|STFT|^power (reference: features/layers.py Spectrogram)."""

    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32"):
        super().__init__()
        self.n_fft, self.power = n_fft, power
        self.hop_length = hop_length or (win_length or n_fft) // 4
        self.win_length = win_length or n_fft
        self.center, self.pad_mode = center, pad_mode
        self.register_buffer(
            "window", Tensor(unwrap(get_window(window, self.win_length,
                                               fftbins=True))
                             .to(convert_dtype(dtype))))

    def forward(self, x):
        spec = stft(x, self.n_fft, self.hop_length, self.win_length,
                    self.window, center=self.center, pad_mode=self.pad_mode)
        p = self.power

        def f(c):
            mag = torch.abs(c)
            return mag if p == 1.0 else mag ** p
        return apply_op("spectrogram_power", f, spec)


class MelSpectrogram(Layer):
    """Spectrogram -> mel filterbank (reference: MelSpectrogram)."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 dtype="float32"):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                        power, center, pad_mode, dtype)
        self.register_buffer(
            "fbank_matrix",
            compute_fbank_matrix(sr, n_fft, n_mels, f_min, f_max, htk, norm,
                                 dtype))

    def forward(self, x):
        spec = self._spectrogram(x)

        def f(s, fb):
            return torch.matmul(fb.to(s.dtype), s)     # mf,...ft->...mt
        return apply_op("mel_fbank", f, spec, self.fbank_matrix)


class LogMelSpectrogram(Layer):
    """MelSpectrogram in dB (reference: LogMelSpectrogram)."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 ref_value=1.0, amin=1e-10, top_db=None, dtype="float32"):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype)
        self.ref_value, self.amin, self.top_db = ref_value, amin, top_db

    def forward(self, x):
        mel = self._melspectrogram(x)
        ref, amin, top = self.ref_value, self.amin, self.top_db

        def f(m):
            return power_to_db(m, ref, amin, top)
        return apply_op("log_mel", f, mel)


class MFCC(Layer):
    """LogMel -> DCT-II cepstral coefficients (reference: MFCC)."""

    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32"):
        super().__init__()
        if n_mfcc > n_mels:
            raise ValueError("n_mfcc cannot be larger than n_mels")
        self._log_melspectrogram = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, ref_value, amin,
            top_db, dtype)
        self.register_buffer("dct_matrix", create_dct(n_mfcc, n_mels, dtype=dtype))

    def forward(self, x):
        logmel = self._log_melspectrogram(x)

        def f(m, d):
            return torch.matmul(d.to(m.dtype).t(), m)  # mk,...mt->...kt
        return apply_op("mfcc_dct", f, logmel, self.dct_matrix)
