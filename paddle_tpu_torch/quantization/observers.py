"""Observers: collect activation/weight ranges for PTQ (reference:
python/paddle/quantization/observers/abs_max.py AbsmaxObserverLayer,
imperative/ptq_quantizer.py AbsmaxQuantizer/PerChannelAbsmaxQuantizer/
HistQuantizer/KLQuantizer).

Counterpart of ``paddle_tpu/quantization/observers.py``: running stats are
updated eagerly (observation is a calibration-time, host-driven pass — it
never needs to be in the compiled training graph); the histogram observers
compute in numpy on a host copy (bfloat16 read as float32)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import unwrap
from ..metric import _host
from .base import BaseObserver, ObserverFactory

__all__ = ["AbsmaxObserver", "AbsmaxObserverLayer", "PerChannelAbsmaxObserver",
           "PerChannelAbsmaxObserverLayer", "HistObserver",
           "HistObserverLayer", "KLObserver", "KLObserverLayer"]


class AbsmaxObserverLayer(BaseObserver):
    """Running max-of-|x| (reference: observers/abs_max.py:48)."""

    def __init__(self, layer=None, quant_bits=8):
        super().__init__()
        self._bits = quant_bits
        self._max = 0.0

    def forward(self, x):
        self._max = max(self._max,
                        float(torch.max(torch.abs(unwrap(x).detach()))))
        return x

    def bit_length(self):
        return self._bits

    def scales(self):
        return Tensor(np.asarray(self._max, np.float32))


class PerChannelAbsmaxObserverLayer(BaseObserver):
    """Per-output-channel |x| max (reference: PerChannelAbsmaxQuantizer)."""

    def __init__(self, layer=None, quant_bits=8, quant_axis=0):
        super().__init__()
        self._bits = quant_bits
        self._axis = quant_axis
        self._max = None

    def forward(self, x):
        a = torch.abs(unwrap(x).detach())
        axes = tuple(i for i in range(a.ndim) if i != self._axis % a.ndim)
        m = torch.amax(a, dim=axes)
        self._max = m if self._max is None else torch.maximum(self._max, m)
        return x

    def bit_length(self):
        return self._bits

    def quant_axis(self):
        return self._axis

    def scales(self):
        return Tensor(self._max.to(torch.float32))


class HistObserverLayer(BaseObserver):
    """Histogram percentile threshold (reference: HistQuantizer).

    Keeps a FIXED-size running histogram of |x| (re-binned when the range
    grows) so calibration memory is O(bins), not O(total activations)."""

    def __init__(self, layer=None, quant_bits=8, bins=2048,
                 percentile=0.9999):
        super().__init__()
        self._bits = quant_bits
        self._bins = bins
        self._pct = percentile
        self._hist = None
        self._maxv = 0.0

    def forward(self, x):
        a = np.abs(_host(x)).ravel()
        if a.size == 0:
            return x
        bmax = float(a.max())
        if self._hist is None:
            self._maxv = max(bmax, 1e-12)
            self._hist = np.histogram(
                a, bins=self._bins, range=(0, self._maxv))[0].astype(
                    np.float64)
            return x
        if bmax > self._maxv:
            # redistribute existing mass into the wider range via the CDF
            old_edges = np.linspace(0, self._maxv, self._bins + 1)
            new_edges = np.linspace(0, bmax, self._bins + 1)
            cum = np.concatenate([[0.0], np.cumsum(self._hist)])
            self._hist = np.diff(np.interp(new_edges, old_edges, cum))
            self._maxv = bmax
        self._hist += np.histogram(a, bins=self._bins,
                                   range=(0, self._maxv))[0]
        return x

    def bit_length(self):
        return self._bits

    def cal_thresholds(self):
        pass

    def _edges(self):
        return np.linspace(0, self._maxv, self._bins + 1)

    def scales(self):
        if self._hist is None:
            return Tensor(np.asarray(0.0, np.float32))
        cdf = np.cumsum(self._hist) / max(self._hist.sum(), 1)
        idx = int(np.searchsorted(cdf, self._pct))
        return Tensor(np.asarray(self._edges()[min(idx + 1, self._bins)],
                                 np.float32))


class KLObserverLayer(HistObserverLayer):
    """KL-minimizing threshold (reference: KLQuantizer — TensorRT-style
    sweep over candidate clip points, pick min KL(P||Q))."""

    def scales(self):
        if self._hist is None:
            return Tensor(np.asarray(0.0, np.float32))
        hist, edges = self._hist.astype(np.float64), self._edges()
        nlevels = 2 ** (self._bits - 1)
        best_kl, best_i = np.inf, self._bins
        for i in range(nlevels, self._bins + 1, max(1, self._bins // 64)):
            p = hist[:i].copy()
            p[-1] += hist[i:].sum()  # clip mass into the last bin
            if p.sum() == 0:
                continue
            # quantize the i-bin histogram down to nlevels buckets
            factor = i / nlevels
            q = np.zeros(i)
            for b in range(nlevels):
                lo, hi = int(b * factor), int((b + 1) * factor)
                seg = hist[lo:hi]
                nz = (seg > 0).sum()
                if nz:
                    q[lo:hi] = np.where(seg > 0, seg.sum() / nz, 0)
            pn, qn = p / p.sum(), q / max(q.sum(), 1e-12)
            m = (pn > 0) & (qn > 0)
            kl = float((pn[m] * np.log(pn[m] / qn[m])).sum())
            if kl < best_kl:
                best_kl, best_i = kl, i
        return Tensor(np.asarray(edges[best_i], np.float32))


class AbsmaxObserver(ObserverFactory):
    def _get_class(self):
        return AbsmaxObserverLayer


class PerChannelAbsmaxObserver(ObserverFactory):
    def _get_class(self):
        return PerChannelAbsmaxObserverLayer


class HistObserver(ObserverFactory):
    def _get_class(self):
        return HistObserverLayer


class KLObserver(ObserverFactory):
    def _get_class(self):
        return KLObserverLayer
