"""Convolution functionals: counterpart of
``paddle_tpu/nn/functional/conv.py`` (reference:
python/paddle/nn/functional/conv.py; kernels phi/kernels/gpudnn/conv_*).

The reference lowers to ``lax.conv_general_dilated``, which XLA compiles;
here the same convolution is ``torch.nn.functional.conv{1,2,3}d`` /
``conv_transpose{1,2,3}d`` (cuDNN on the card), as a plain matrix product
stays ``torch.matmul``.  Paddle's weight layout ([out, in / groups,
*kernel]; transposed: [in, out / groups, *kernel]) is torch's.  Padding
follows the reference: an int, one per spatial dim, (lo, hi) pairs or a
flat [lo0, hi0, lo1, hi1, ...] list, or "SAME" / "VALID" as XLA resolves
them; asymmetric pads are applied with ``F.pad`` before the convolution.
Channel-last formats are moved to channel-first around it.
"""
from __future__ import annotations

import math

import torch.nn.functional as TF

from ...core.dispatch import apply_op

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _padding(padding, n):
    if isinstance(padding, str):
        return padding.upper()  # SAME / VALID
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            # could be per-dim pairs
            return [tuple(p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _resolve(pad, sizes, window, strides):
    """Explicit (lo, hi) pairs for ``pad``, strings as XLA's
    ``padtype_to_pads`` resolves them over ``sizes``: VALID none, SAME the
    output ceil(size / stride) with the odd pad at the high end."""
    if not isinstance(pad, str):
        return [tuple(int(v) for v in p) for p in pad]
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    out = []
    for size, k, s in zip(sizes, window, strides):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        out.append((total // 2, total - total // 2))
    return out


def _channel_last(data_format):
    return data_format in ("NHWC", "NWC", "NDHWC", "NLC")


def _to_first(a, channel_last):
    return a.movedim(-1, 1) if channel_last else a


def _to_last(a, channel_last):
    return a.movedim(1, -1) if channel_last else a


def _flat_pads(pads):
    """(lo, hi) pairs, first spatial dim first, as ``F.pad``'s flat list
    (last dim first)."""
    return [v for p in reversed(pads) for v in p]


def _conv(x, weight, bias, stride, padding, dilation, groups, n, data_format, name):
    channel_last = _channel_last(data_format)
    st = _tuple(stride, n)
    dl = _tuple(dilation, n)
    pad = _padding(padding, n)

    def f(a, w, *b):
        a = _to_first(a, channel_last)
        ks = w.shape[2:]
        eff = [d * (k - 1) + 1 for d, k in zip(dl, ks)]
        pads = _resolve(pad, a.shape[2:], eff, st)
        if all(lo == hi for lo, hi in pads):
            sym = [lo for lo, _ in pads]
        else:
            a, sym = TF.pad(a, _flat_pads(pads)), 0
        out = _CONV[n](a, w, b[0].to(a.dtype) if b else None, st, sym, dl,
                       groups)
        return _to_last(out, channel_last)
    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply_op(name, f, *args)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, df, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2, data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3, data_format, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                    n, data_format, output_size, name):
    """The reference's transposed convolution: a convolution of the input
    dilated by ``stride`` with the flipped kernel, padded d (k - 1) - lo and
    d (k - 1) - hi + output_padding (strings resolved over the dilated
    input, as XLA does; with a stride above 1 it raises, as the reference's
    does).  Here: torch's unpadded transposed convolution (the
    full output), then the window of it those pads select, zeros where the
    window runs past it.  ``output_size`` is not read, as in the
    reference."""
    channel_last = _channel_last(data_format)
    st = _tuple(stride, n)
    dl = _tuple(dilation, n)
    opad = _tuple(output_padding, n) if output_padding is not None else (0,) * n
    pad = _padding(padding, n)

    def f(a, w, *b):
        a = _to_first(a, channel_last)
        ks = w.shape[2:]
        span = [d * (k - 1) for d, k in zip(dl, ks)]
        if isinstance(pad, str):
            if any(s > 1 for s in st):
                raise ValueError(
                    "String padding is not implemented for a strided "
                    "transposed convolution: give the padding explicitly")
            dilated = [(i - 1) * s + 1 for i, s in zip(a.shape[2:], st)]
            lohi = _resolve(pad, dilated, [s + 1 for s in span], (1,) * n)
        else:
            lohi = [(span[i] - pad[i][0], span[i] - pad[i][1] + opad[i])
                    for i in range(n)]
        full = _CONV_T[n](a, w, None, st, 0, 0, groups, dl)
        # the window [span - lo, full + hi - span) of the full output
        cut = []
        for i, (lo, hi) in enumerate(lohi):
            start, stop = span[i] - lo, full.shape[2 + i] + hi - span[i]
            cut.append((-start, stop - full.shape[2 + i]))
        out = TF.pad(full, _flat_pads(cut))
        if b:
            shape = [1] * out.ndim
            shape[1] = b[0].shape[0]
            out = out + b[0].reshape(shape).to(out.dtype)
        return _to_last(out, channel_last)
    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply_op(name, f, *args)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                           groups, 1, df, output_size, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                           groups, 2, data_format, output_size, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                           groups, 3, data_format, output_size, "conv3d_transpose")
