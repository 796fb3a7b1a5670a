"""Statistics ops: counterpart of ``paddle_tpu/ops/stat.py`` (reference:
python/paddle/tensor/stat.py).

``median``'s default ``mode="avg"`` averages the two middle values of an
even count (``jnp.median``); ``torch.median`` returns the lower one, which
is ``mode="min"`` here.  Integer inputs of ``var`` / ``std`` compute in the
default float dtype, as ``jnp.var`` does.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.dispatch import apply_op, unwrap


def _float(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(
        dtypes.get_default_dtype())


def _dims(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _last(a, axis):
    """``a`` with the reduced axes moved to the end and merged into one,
    and the shape a ``keepdim`` result takes."""
    if axis is None:
        return a.reshape(-1), (1,) * a.ndim
    axes = [ax % a.ndim for ax in ((axis,) if isinstance(axis, int)
                                   else axis)]
    rest = [i for i in range(a.ndim) if i not in axes]
    kept = tuple(1 if i in axes else a.shape[i] for i in range(a.ndim))
    out = a.permute(rest + axes)
    return out.reshape(out.shape[:len(rest)] + (-1,)), kept


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op("var", lambda a: torch.var(
        _float(a), dim=_dims(axis), correction=1 if unbiased else 0,
        keepdim=keepdim), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op("std", lambda a: torch.std(
        _float(a), dim=_dims(axis), correction=1 if unbiased else 0,
        keepdim=keepdim), x)


def _midpoint(flat, n):
    """Per row of ``flat`` (sorted, NaNs last), the mean of the two middle
    values of its first ``n`` entries (the middle one for an odd ``n``)."""
    lo = torch.gather(flat, -1, ((n - 1) // 2).clamp_min(0)[..., None])
    hi = torch.gather(flat, -1, (n // 2).clamp_max(flat.shape[-1] - 1)[..., None])
    return ((lo + hi) / 2)[..., 0]


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def f(a):
        if mode == "avg":
            flat, kept = _last(_float(a), axis)
            srt = torch.sort(flat, dim=-1).values
            n = torch.full(srt.shape[:-1], srt.shape[-1], device=a.device)
            out = _midpoint(srt, n)
            out = torch.where(torch.isnan(flat).any(-1),
                              torch.full_like(out, float("nan")), out)
            return out.reshape(kept) if keepdim else out
        # mode == 'min': lower median
        if axis is None:
            flat = torch.sort(a.reshape(-1)).values
            return flat[(flat.shape[0] - 1) // 2]
        srt = torch.sort(a, dim=axis).values
        out = srt.select(axis, (a.shape[axis] - 1) // 2)
        return out.unsqueeze(axis) if keepdim else out
    return apply_op("median", f, x)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    def f(a):
        flat, kept = _last(_float(a), axis)
        srt = torch.sort(flat, dim=-1).values          # NaNs sort last
        n = (~torch.isnan(flat)).sum(-1)
        out = torch.where(n > 0, _midpoint(srt, n),
                          torch.full(n.shape, float("nan"), dtype=srt.dtype,
                                     device=a.device))
        return out.reshape(kept) if keepdim else out
    return apply_op("nanmedian", f, x)


def _quantile(fn, a, qq, axis, keepdim, interpolation):
    q = (torch.as_tensor(qq, dtype=torch.float32, device=a.device)
         if not isinstance(qq, (int, float)) else float(qq))
    flat, kept = _last(a.float(), axis)
    out = fn(flat, q, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(out.shape[:out.ndim - flat.ndim + 1] + kept)
    return out


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    qq = unwrap(q)
    return apply_op("quantile", lambda a: _quantile(
        torch.quantile, a, qq, axis, keepdim, interpolation), x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    qq = unwrap(q)
    return apply_op("nanquantile", lambda a: _quantile(
        torch.nanquantile, a, qq, axis, keepdim, interpolation), x)
