"""Shape/layout manipulation ops: counterpart of
``paddle_tpu/ops/manipulation.py`` (reference:
python/paddle/tensor/manipulation.py).

Index tensors are stored as int32 (the reference's narrowed int64); torch
wants int64 indices, so each op widens them inside.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..core import dtype as dtypes
from ..core.dispatch import apply_op, unwrap

builtins_sum = builtins.sum
slice_builtin = builtins.slice


def _shape_arg(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    out = []
    for s in (shape if isinstance(shape, (list, tuple)) else [shape]):
        out.append(int(unwrap(s)) if not isinstance(s, (int, np.integer)) else int(s))
    return tuple(out)


def _index(v, device):
    """An index operand (Tensor, tensor, array, list) as a torch tensor on
    ``device``: integers widened to int64, booleans kept."""
    t = unwrap(v)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    t = t.to(device)
    return t if t.dtype == torch.bool else t.long()


def cast(x, dtype):
    dt = dtypes.convert_dtype(dtype)
    return apply_op("cast", lambda a: a.to(dt), x)


def reshape(x, shape, name=None):
    sh = _shape_arg(shape)
    return apply_op("reshape", lambda a: torch.reshape(a, sh), x)


def reshape_(x, shape, name=None):
    out = reshape(x, shape)
    x._data = out._data
    return x


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def transpose(x, perm, name=None):
    p = tuple(int(i) for i in perm)
    return apply_op("transpose", lambda a: a.permute(p), x)


def moveaxis(x, source, destination, name=None):
    return apply_op("moveaxis", lambda a: torch.movedim(a, source, destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply_op("swapaxes", lambda a: torch.swapaxes(a, axis0, axis1), x)

transpose_ = swapaxes


def t(x, name=None):
    def f(a):
        return a if a.ndim < 2 else a.t()
    return apply_op("t", f, x)


def squeeze(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(ax % a.ndim for ax in axes)
        axes = tuple(ax for ax in axes if a.shape[ax] == 1)
        return torch.squeeze(a, axes) if axes else a
    return apply_op("squeeze", f, x)


def unsqueeze(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = [int(unwrap(a)) for a in axes]

    def f(a):
        out = a
        for ax in sorted(ax if ax >= 0 else ax + out.ndim + 1 for ax in axes):
            out = out.unsqueeze(ax)
        return out
    return apply_op("unsqueeze", f, x)


def concat(x, axis=0, name=None):
    ax = int(unwrap(axis))
    return apply_op("concat", lambda *arrs: torch.cat(arrs, dim=ax), *x)


def stack(x, axis=0, name=None):
    return apply_op("stack", lambda *arrs: torch.stack(arrs, dim=axis), *x)


def split(x, num_or_sections, axis=0, name=None):
    ax = int(unwrap(axis))

    def f(a):
        n = a.shape[ax]
        if isinstance(num_or_sections, int):
            if n % num_or_sections:
                raise ValueError(f"axis {ax} of size {n} does not split into "
                                 f"{num_or_sections} equal sections")
            return tuple(torch.split(a, n // num_or_sections, dim=ax))
        secs = [int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(secs) if s < 0]
        if neg:
            secs[neg[0]] = n - builtins_sum(s for s in secs if s >= 0)
        return tuple(torch.split(a, secs, dim=ax))
    out = apply_op("split", f, x)
    return list(out) if isinstance(out, tuple) else [out]


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(input, axis=0, name=None):
    out = apply_op("unbind", lambda a: tuple(torch.unbind(a, axis)), input)
    return list(out) if isinstance(out, tuple) else [out]


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(a):
        nd = a.ndim
        if nd == 0:
            return a.reshape(1)
        s0 = start_axis % nd
        s1 = stop_axis % nd
        return a.reshape(a.shape[:s0] + (-1,) + a.shape[s1 + 1:])
    return apply_op("flatten", f, x)


def tile(x, repeat_times, name=None):
    reps = _shape_arg(repeat_times)
    return apply_op("tile", lambda a: torch.tile(a, reps), x)


def expand(x, shape, name=None):
    sh = list(_shape_arg(shape))

    def f(a):
        full = list(sh)
        # -1 means keep original dim (paddle semantics)
        offset = len(full) - a.ndim
        for i in range(len(full)):
            if full[i] == -1:
                full[i] = a.shape[i - offset]
        return a.expand(full)
    return apply_op("expand", f, x)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_tensors(input, name=None):
    shapes = [tuple(t.shape) for t in input]
    target = np.broadcast_shapes(*shapes)
    return [expand(t, list(target)) for t in input]


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply_op("flip", lambda a: torch.flip(a, tuple(axes)), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op("rot90", lambda a: torch.rot90(a, k, tuple(axes)), x)


def roll(x, shifts, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.roll(a.reshape(-1), shifts).reshape(a.shape)
        return torch.roll(a, shifts, axis)
    return apply_op("roll", f, x)


def gather(x, index, axis=0, name=None):
    ax = int(unwrap(axis))

    def f(a):
        i = _index(index, a.device)
        return torch.index_select(a, ax, i.reshape(-1))
    return apply_op("gather", f, x)


def gather_nd(x, index, name=None):
    def f(a):
        i = _index(index, a.device)
        return a[tuple(torch.movedim(i, -1, 0))]
    return apply_op("gather_nd", f, x)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def f(a):
        i = _index(indices, a.device)
        ax = axis % a.ndim
        if broadcast:
            tgt = list(np.broadcast_shapes(
                tuple(a.shape[:ax] + (1,) + a.shape[ax + 1:]),
                tuple(i.shape)))
            tgt[ax] = i.shape[ax]
            i = i.expand(tgt)
        return torch.take_along_dim(a, i, dim=ax)
    return apply_op("take_along_axis", f, arr)


_SCATTER_REDUCE = {"mul": "prod", "multiply": "prod", "amax": "amax",
                   "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True, name=None):
    def f(a, v):
        idx = _index(indices, a.device)
        v = (v.to(a.dtype) if isinstance(v, torch.Tensor)
             else torch.tensor(v, dtype=a.dtype, device=a.device)
             ).expand(idx.shape)
        if reduce == "assign":
            return torch.scatter(a, axis, idx, v)
        if reduce in ("add", "sum"):
            return torch.scatter_add(a, axis, idx, v)
        if reduce in _SCATTER_REDUCE:
            return torch.scatter_reduce(a, axis, idx, v,
                                        _SCATTER_REDUCE[reduce])
        raise ValueError(f"unknown reduce {reduce}")
    if isinstance(values, (int, float)):
        return apply_op("put_along_axis", lambda a: f(a, values), arr)
    return apply_op("put_along_axis", f, arr, values)


def index_select(x, index, axis=0, name=None):
    return apply_op("index_select", lambda a: torch.index_select(
        a, axis, _index(index, a.device)), x)


def index_add(x, index, axis, value, name=None):
    return apply_op("index_add", lambda a, v: torch.index_add(
        a, axis, _index(index, a.device), v), x, value)


def index_put(x, indices, value, accumulate=False, name=None):
    def f(a, v):
        ix = tuple(_index(i, a.device) for i in indices)
        v = v.to(a.dtype) if isinstance(v, torch.Tensor) else torch.tensor(
            v, dtype=a.dtype, device=a.device)
        return torch.index_put(a, ix, v, accumulate=accumulate)
    return apply_op("index_put", f, x, value)


def scatter(x, index, updates, overwrite=True, name=None):
    def f(a, u):
        ix = (_index(index, a.device),)
        if overwrite:
            return torch.index_put(a, ix, u)
        base = torch.index_put(a, ix, torch.zeros_like(u))
        return torch.index_put(base, ix, u, accumulate=True)
    return apply_op("scatter", f, x, updates)


def scatter_nd_add(x, index, updates, name=None):
    def f(a, u):
        ix = tuple(torch.movedim(_index(index, a.device), -1, 0))
        return torch.index_put(a, ix, u, accumulate=True)
    return apply_op("scatter_nd_add", f, x, updates)


def scatter_nd(index, updates, shape, name=None):
    sh = _shape_arg(shape)

    def f(u):
        a = torch.zeros(sh, dtype=u.dtype, device=u.device)
        ix = tuple(torch.movedim(_index(index, u.device), -1, 0))
        return torch.index_put(a, ix, u, accumulate=True)
    return apply_op("scatter_nd", f, updates)


def slice(input, axes, starts, ends, name=None):
    starts = [int(unwrap(s)) for s in starts]
    ends = [int(unwrap(e)) for e in ends]

    def f(a):
        sl = [slice_builtin(None)] * a.ndim
        for ax, s, e in zip(axes, starts, ends):
            n = a.shape[ax]
            s2 = np.clip(s + n if s < 0 else s, 0, n)
            e2 = np.clip(e + n if e < 0 else e, 0, n)
            sl[ax] = slice_builtin(int(s2), int(e2))
        return a[tuple(sl)]
    return apply_op("slice", f, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def f(a):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            sl = slice_builtin(int(unwrap(s)), int(unwrap(e)), int(unwrap(st)))
            if sl.step > 0:
                full = [slice_builtin(None)] * a.ndim
                full[ax] = sl
                a = a[tuple(full)]
            else:                        # torch slices take no negative step
                idx = list(range(a.shape[ax]))[sl]
                a = torch.index_select(a, ax, torch.tensor(
                    idx, dtype=torch.long, device=a.device))
        return a
    return apply_op("strided_slice", f, x)


def repeat_interleave(x, repeats, axis=None, name=None):
    def f(a):
        r = unwrap(repeats)
        r = _index(r, a.device) if not isinstance(r, int) else r
        if axis is None:
            return torch.repeat_interleave(a.reshape(-1), r, dim=0)
        return torch.repeat_interleave(a, r, dim=axis)
    return apply_op("repeat_interleave", f, x)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """The reference delegates to ``nn.functional.pad``; its padding
    conventions: one (before, after) pair a dim when ``pad`` covers every
    dim, else the last spatial dims innermost first."""
    pad_list = [int(unwrap(p)) for p in (pad if isinstance(pad, (list, tuple))
                                         else np.asarray(unwrap(pad)).tolist())]

    def f(a):
        nd = a.ndim
        if len(pad_list) == 2 * nd:
            widths = [(pad_list[2 * i], pad_list[2 * i + 1]) for i in range(nd)]
        else:
            k = len(pad_list) // 2
            widths = [(0, 0)] * nd
            if data_format.endswith("C") and nd > 2:
                spatial = list(range(1, nd - 1))
            else:
                spatial = list(range(nd - k, nd))
            for i in range(k):
                widths[spatial[-(i + 1)]] = (pad_list[2 * i], pad_list[2 * i + 1])
        flat = [w for pair in reversed(widths) for w in pair]
        if mode == "constant":
            return torch.nn.functional.pad(a, flat, value=value)
        while flat and flat[-2:] == [0, 0]:   # the padded dims only
            flat = flat[:-2]
        lead = nd - len(flat) // 2
        b = a.reshape((-1,) + a.shape[lead:]).unsqueeze(0)
        out = torch.nn.functional.pad(b, flat, mode={
            "reflect": "reflect", "replicate": "replicate",
            "circular": "circular"}[mode])
        return out.reshape(a.shape[:lead] + out.shape[2:])
    return apply_op("pad", f, x)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(a):
        size = index_num // nshards
        shard = torch.div(a, size, rounding_mode="floor")
        return torch.where(shard == shard_id, a % size,
                           torch.full_like(a, ignore_value))
    return apply_op("shard_index", f, input)


def _host_out(a, device):
    """A host result (numpy) as a Tensor on ``device``, narrowed to 32 bits."""
    t = torch.as_tensor(a, device=device)
    narrow = dtypes.NARROW.get(t.dtype)
    return _wrap(t.to(narrow) if narrow is not None else t)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    device = unwrap(x).device
    arr = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    if axis is None:
        arr = arr.reshape(-1)
    keep = np.concatenate([[True], arr[1:] != arr[:-1]]) if arr.ndim == 1 else None
    out = arr[keep]
    res = [_host_out(out, device)]
    if return_inverse:
        res.append(_host_out(np.cumsum(keep) - 1, device))
    if return_counts:
        idx = np.nonzero(keep)[0]
        res.append(_host_out(np.diff(np.append(idx, arr.size)), device))
    return res[0] if len(res) == 1 else tuple(res)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    """Dynamic-shape op: eager only (host round-trip), like the reference's CPU sync."""
    device = unwrap(x).device
    arr = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    out = np.unique(arr, return_index=return_index, return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(out, tuple):
        return _host_out(out, device)
    return tuple(_host_out(o, device) for o in out)


def as_complex(x, name=None):
    return apply_op("as_complex", lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return apply_op("as_real", lambda a: torch.stack([a.real, _imag(a)], -1), x)


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(axes, (list, tuple)):
        ax = [list(a) if isinstance(a, (list, tuple)) else a for a in axes]
    return apply_op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax), x, y)


def atleast_1d(*inputs, name=None):
    outs = [apply_op("atleast_1d", torch.atleast_1d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply_op("atleast_2d", torch.atleast_2d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply_op("atleast_3d", torch.atleast_3d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def unfold(x, axis, size, step, name=None):
    return apply_op("unfold", lambda a: a.unfold(axis, size, step), x)


def masked_fill(x, mask, value, name=None):
    def m_of(a):
        m = unwrap(mask)
        return m.to(a.device) if isinstance(m, torch.Tensor) else \
            torch.as_tensor(np.asarray(m), device=a.device)
    if isinstance(value, (int, float)):
        return apply_op("masked_fill", lambda a: a.masked_fill(m_of(a), value), x)
    return apply_op("masked_fill", lambda a, v: torch.where(
        m_of(a), v.to(a.dtype), a), x, value)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    def f(a):
        n = builtins.min(a.shape[-2], a.shape[-1])
        i = torch.arange(n - builtins.abs(offset) if offset else n,
                         device=a.device)
        out = a.clone()
        if offset >= 0:
            out[..., i, i + offset] = value
        else:
            out[..., i - offset, i] = value
        return out
    return apply_op("fill_diagonal", f, x)
