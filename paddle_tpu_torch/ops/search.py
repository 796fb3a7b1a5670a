"""Search/sort ops: counterpart of ``paddle_tpu/ops/search.py`` (reference:
python/paddle/tensor/search.py).

Ties order as the reference's: ``topk`` / ``kthvalue`` / ``argsort`` go
through a stable sort, so equal values keep their index order (the lower
index first, as ``jax.lax.top_k`` and a stable ``jnp.argsort`` give).
Dynamic-output-shape ops (``nonzero``, ``masked_select``, ``mode``) read the
host, as the reference's do: under program capture that read is a host
conversion of the context (``Tensor.numpy``), which breaks the step there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dtype import convert_dtype
from ..core.dispatch import apply_op, unwrap
from .manipulation import _host_out


def _arg(fn, x, axis, keepdim, dtype, name):
    dt = convert_dtype(dtype)

    def f(a):
        if axis is None:
            out = fn(a.reshape(-1))
            out = out.reshape((1,) * a.ndim) if keepdim else out
        else:
            out = fn(a, dim=axis, keepdim=keepdim)
        return out.to(dt)
    return apply_op(name, f, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype, "argmax")


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype, "argmin")


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    def f(a):
        return torch.argsort(-a if descending else a, dim=axis, stable=True)
    return apply_op("argsort", f, x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def f(a):
        out = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(out, dims=(axis,)) if descending else out
    return apply_op("sort", f, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(unwrap(k))

    def f(a):
        ax = (axis if axis is not None else a.ndim - 1) % a.ndim
        vals, idx = torch.sort(a, dim=ax, descending=largest, stable=True)
        return vals.narrow(ax, 0, kk), idx.narrow(ax, 0, kk)
    return apply_op("topk", f, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        ax = axis % a.ndim
        vals, idx = torch.sort(a, dim=ax, stable=True)
        v, i = vals.select(ax, k - 1), idx.select(ax, k - 1)
        if keepdim:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i
    return apply_op("kthvalue", f, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """(the most common value, its count) along ``axis``: the smallest of
    the most common values, as the reference's ``scipy.stats.mode``."""
    from scipy import stats as _stats
    device = unwrap(x).device
    m = _stats.mode(x.numpy(), axis=axis, keepdims=keepdim)
    return _host_out(m.mode, device), _host_out(m.count.astype(np.int64),
                                                device)


def nonzero(x, as_tuple=False):
    device = unwrap(x).device
    nz = np.nonzero(x.numpy())
    if as_tuple:
        return tuple(_host_out(i.astype(np.int64).reshape(-1), device)
                     for i in nz)
    return _host_out(np.stack(nz, axis=1).astype(np.int64), device)


def masked_select(x, mask, name=None):
    device = unwrap(x).device
    arr = x.numpy()
    m = mask.numpy() if isinstance(mask, Tensor) else np.asarray(mask)
    return _host_out(arr[np.broadcast_to(m, arr.shape)], device)


def index_sample(x, index):
    idx = unwrap(index)
    return apply_op("index_sample",
                    lambda a: torch.gather(a, 1, idx.to(a.device).long()), x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    def f(seq, v):
        if seq.ndim > 1:
            v = v.broadcast_to(seq.shape[:-1] + v.shape[-1:]).contiguous()
        return torch.searchsorted(seq.contiguous(), v, right=right,
                                  out_int32=out_int32)
    return apply_op("searchsorted", f, sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)
