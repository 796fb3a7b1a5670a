"""Pooling functionals: counterpart of ``paddle_tpu/nn/functional/pooling.py``
(reference: python/paddle/nn/functional/pooling.py).

The reference reduces windows with ``lax.reduce_window`` over explicitly
padded inputs; here the padding is explicit too (``F.pad``: -inf, or the
dtype's lowest value, for max; zeros for average), then torch's unpadded
pool runs, so ``ceil_mode`` (the reference's: the high pad grown until the
last partial window fits) and asymmetric or "SAME" padding give the
reference's windows exactly.  ``exclusive`` averages over the window's
elements inside the input (the inverse of torch's ``count_include_pad``).
Adaptive pools use the same bins as the reference (start floor(i n / o),
end ceil((i + 1) n / o)), which are torch's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from .conv import (_tuple, _padding, _resolve, _flat_pads, _channel_last,
                   _to_first, _to_last)

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _window_pads(sizes, ks, st, pad, ceil_mode):
    """The reference's (lo, hi) pads of each spatial dim: ``pad`` resolved,
    then with ``ceil_mode`` the high pad grown so the last partial window
    is kept."""
    pads = _resolve(pad, sizes, ks, st)
    if ceil_mode:
        for i, size in enumerate(sizes):
            rem = (size + pads[i][0] + pads[i][1] - ks[i]) % st[i]
            if rem:
                pads[i] = (pads[i][0], pads[i][1] + st[i] - rem)
    return pads


def _lowest(dtype):
    """The max pool's padding value: -inf, or the lowest finite value for
    the narrow floats (fp8 has no inf: -inf would cast to NaN and poison
    the max) and integers, as the reference's ``init``."""
    if dtype.is_floating_point:
        fi = torch.finfo(dtype)
        return float("-inf") if fi.max > 1e38 else float(fi.min)
    return torch.iinfo(dtype).min


def _pool(x, kernel, stride, padding, n, data_format, reducer, name,
          ceil_mode=False, exclusive=True):
    channel_last = _channel_last(data_format)
    ks = _tuple(kernel, n)
    st = _tuple(stride if stride is not None else kernel, n)
    pad = _padding(padding, n)

    def f(a):
        a = _to_first(a, channel_last)
        pads = _flat_pads(_window_pads(a.shape[2:], ks, st, pad, ceil_mode))
        if reducer == "max":
            out = _MAX[n](TF.pad(a, pads, value=_lowest(a.dtype)), ks, st)
            return _to_last(out, channel_last)
        area = float(math.prod(ks))
        s = _AVG[n](TF.pad(a.float(), pads), ks, st) * area
        if exclusive:
            ones = torch.ones((1, 1) + tuple(a.shape[2:]), device=a.device)
            cnt = _AVG[n](TF.pad(ones, pads), ks, st) * area
            out = s / cnt
        else:
            out = s / area
        return _to_last(out.to(a.dtype), channel_last)
    return apply_op(name, f, x)


def _max_pool_with_mask(x, kernel_size, stride, padding, n, name,
                        ceil_mode=False):
    """(pooled, argmax-mask): mask holds the flat spatial index into the
    INPUT per window (reference max_pool*_with_index kernels; consumed by
    max_unpool*). NCHW/NCL only. Padded positions can never win (they are
    -inf), so indices always point at real input elements."""
    ks = _tuple(kernel_size, n)
    st = _tuple(stride if stride is not None else kernel_size, n)
    pad = _padding(padding, n)
    if isinstance(pad, str):
        raise NotImplementedError("return_mask needs explicit int padding")

    def f(a):
        a4 = a[..., None] if n == 1 else a            # NCL -> NCL1
        ks2, st2 = (ks + (1,), st + (1,)) if n == 1 else (ks, st)
        pad2 = list(pad) + [(0, 0)] if n == 1 else list(pad)
        H, W = a4.shape[2:]
        pads = _window_pads((H, W), ks2, st2, pad2, ceil_mode)
        padded = TF.pad(a4, _flat_pads(pads), value=_lowest(a.dtype))
        out, idx = TF.max_pool2d(padded, ks2, st2, return_indices=True)
        wp = padded.shape[-1]
        h, w = idx // wp - pads[0][0], idx % wp - pads[1][0]
        mask = (h * W + w).to(torch.int32)
        if n == 1:
            return out[..., 0], mask[..., 0]
        return out, mask

    return apply_op(name + "_with_mask", f, x)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        if data_format != "NCL":
            raise ValueError("return_mask supports NCL only")
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1,
                                   "max_pool1d", ceil_mode)
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _pool(x, kernel_size, stride, padding, 1, df, "max", "max_pool1d",
                 ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask supports NCHW only")
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2,
                                   "max_pool2d", ceil_mode)
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 "max_pool2d", ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError("max_pool3d return_mask")
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 "max_pool3d", ceil_mode)


def _unpool_size(in_sp, kernel, stride, padding, output_size):
    if output_size is not None:
        return tuple(int(v) for v in output_size[-len(kernel):]) \
            if len(output_size) >= len(kernel) else tuple(output_size)
    return tuple((i - 1) * s - 2 * p[0] + k for i, k, s, p in
                 zip(in_sp, kernel, stride, padding))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Inverse of max_pool2d(return_mask=True): scatter pooled values back to
    their argmax positions (reference: phi unpool kernel / F.max_unpool2d)."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW only")
    ks = _tuple(kernel_size, 2)
    st = _tuple(stride if stride is not None else kernel_size, 2)
    pad = _padding(padding, 2)

    def f(a, idx):
        N, C, Ho, Wo = a.shape
        H, W = _unpool_size((Ho, Wo), ks, st, pad, output_size)
        # an index past H * W lands in one extra slot, then dropped (the
        # reference's scatter drops it)
        idx = idx.reshape(N, C, -1).long().clamp_max(H * W)
        flat = torch.zeros((N, C, H * W + 1), dtype=a.dtype, device=a.device)
        out = flat.scatter(2, idx, a.reshape(N, C, -1))
        return out[..., :H * W].reshape(N, C, H, W)

    return apply_op("max_unpool2d", f, x, indices)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    """1-D unpool via the 2-D path on an NCL1 view (mask indices are flat
    spatial positions, identical between L and L x 1 layouts)."""
    ks = _tuple(kernel_size, 1)
    st = _tuple(stride if stride is not None else kernel_size, 1)
    pad = _padding(padding, 1)
    if output_size is None:
        Lo = x.shape[-1]
        output_size = ((Lo - 1) * st[0] - 2 * pad[0][0] + ks[0],)
    os4 = tuple(output_size)[-1:] + (1,)
    out = max_unpool2d(x.unsqueeze(-1), indices.unsqueeze(-1),
                       (ks[0], 1), (st[0], 1), padding=0, output_size=os4)
    return out.squeeze(-1)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _pool(x, kernel_size, stride, padding, 1, df, "avg", "avg_pool1d",
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 "avg_pool2d", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 "avg_pool3d", ceil_mode, exclusive)


def _adaptive(x, output_size, n, data_format, kind, name):
    channel_last = _channel_last(data_format)
    os_ = _tuple(output_size, n) if output_size is not None else (None,) * n

    def f(a):
        b = _to_first(a, channel_last)
        size = [o if o is not None else s for o, s in zip(os_, b.shape[2:])]
        out = _ADAPTIVE[(kind, n)](b.float() if kind == "avg" else b, size)
        return _to_last(out.to(a.dtype), channel_last)
    return apply_op(name, f, x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "NCW", "avg", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format, "avg", "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format, "avg", "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "NCW", "max", "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "NCHW", "max", "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "NCDHW", "max", "adaptive_max_pool3d")
