"""Manipulation/indexing ops closing the paddle.tensor surface gap:
counterpart of ``paddle_tpu/ops/manip_extra.py`` (reference:
python/paddle/tensor/manipulation.py — tensor_split family, unstack, take,
unflatten, as_strided, scatter variants; kernels phi/kernels/*).  Each op
is one ``apply_op`` of torch math; the scatters write into a copy, so
every input keeps its gradient path."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from . import manipulation as _manip
from . import logic as _logic


def reverse(x, axis, name=None):
    return _manip.flip(x, axis)


less = _logic.less_than
bitwise_invert = _logic.bitwise_not


def tensor_split(x, num_or_indices, axis=0, name=None):
    n = x.shape[axis] if hasattr(x, "shape") else None
    if isinstance(num_or_indices, int):
        k = num_or_indices
        base, rem = divmod(n, k)
        sizes = [base + (1 if i < rem else 0) for i in range(k)]
        bounds = np.cumsum([0] + sizes)
    else:
        idx = list(num_or_indices)
        bounds = [0] + idx + [n]
    outs = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        a, b = int(a), int(b)
        outs.append(apply_op("tensor_split",
                             lambda arr, a=a, b=b:
                             torch.narrow(arr, axis, a, max(b - a, 0)), x))
    return outs


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if x.ndim > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def unstack(x, axis=0, num=None, name=None):
    n = num or x.shape[axis]
    return [apply_op("unstack",
                     lambda a, i=i: torch.select(a, axis, i), x)
            for i in range(n)]


def take(x, index, mode="raise", name=None):
    """Flat gather; "raise" clamps as the reference's (no host check)."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"take mode must be raise/wrap/clip, got {mode}")

    def f(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        i = i.long()
        i = torch.remainder(i, n) if mode == "wrap" else torch.clip(i, 0, n - 1)
        return flat[i]
    return apply_op("take", f, x, index)


def unflatten(x, axis, shape, name=None):
    shape = [int(s) for s in (shape.tolist() if isinstance(shape, Tensor)
                              else shape)]

    def f(a):
        ax = axis if axis >= 0 else a.ndim + axis
        new = list(a.shape[:ax]) + shape + list(a.shape[ax + 1:])
        # resolve a single -1
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            new[new.index(-1)] = a.shape[ax] // known
        return a.reshape(new)
    return apply_op("unflatten", f, x)


def as_strided(x, shape, stride, offset=0, name=None):
    """Strided view via gather on the flat buffer (the reference
    materializes it the same way)."""
    shape = [int(s) for s in shape]
    stride = [int(s) for s in stride]

    def f(a):
        idx = np.asarray(offset)
        for s, st in zip(shape, stride):
            idx = idx[..., None] + np.arange(s) * st
        return a.reshape(-1)[torch.as_tensor(idx.reshape(shape),
                                             device=a.device)]
    return apply_op("as_strided", f, x)


def view_as(x, other, name=None):
    return _manip.reshape(x, list(other.shape))


def matrix_transpose(x, name=None):
    return apply_op("matrix_transpose", lambda a: torch.swapaxes(a, -2, -1), x)


def rank(x, name=None):
    return Tensor(torch.tensor(len(x.shape), dtype=torch.int32,
                               device=unwrap(x).device))


def is_complex(x):
    return bool(unwrap(x).is_complex())


def is_integer(x):
    b = unwrap(x)
    return not (b.is_floating_point() or b.is_complex()
                or b.dtype == torch.bool)


def is_floating_point(x):
    return bool(unwrap(x).is_floating_point())


def _slices_for(axes, starts, ends, strides, ndim):
    sl = [slice(None)] * ndim
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        sl[ax] = slice(int(st), int(en), int(sr))
    return tuple(sl)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(a, v):
        sl = _slices_for(axes, starts, ends, strides, a.ndim)
        out = a.clone()
        out[sl] = v.to(a.dtype)
        return out
    return apply_op("slice_scatter", f, x, value)


def select_scatter(x, values, axis, index, name=None):
    def f(a, v):
        sl = [slice(None)] * a.ndim
        sl[axis] = int(index)
        out = a.clone()
        out[tuple(sl)] = v.to(a.dtype)
        return out
    return apply_op("select_scatter", f, x, values)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    def f(a, v):
        n, m = a.shape[axis1], a.shape[axis2]
        if offset >= 0:
            k = min(n, m - offset)
            rows, cols = np.arange(k), np.arange(k) + offset
        else:
            k = min(n + offset, m)
            rows, cols = np.arange(k) - offset, np.arange(k)
        moved = torch.movedim(a, (axis1, axis2), (0, 1)).clone()
        # v's diagonal dim is last; bring it first to line up with [rows, cols]
        vmoved = torch.movedim(v, -1, 0) if v.ndim == a.ndim - 1 else v
        moved[torch.as_tensor(rows), torch.as_tensor(cols)] = vmoved.to(
            a.dtype)
        return torch.movedim(moved, (0, 1), (axis1, axis2))
    return apply_op("diagonal_scatter", f, x, y)


def index_fill(x, index, axis, value, name=None):
    def f(a, i):
        moved = torch.movedim(a, axis, 0).clone()
        moved[i.long()] = torch.as_tensor(value, dtype=a.dtype,
                                          device=a.device)
        return torch.movedim(moved, 0, axis)
    return apply_op("index_fill", f, x, index)


def masked_scatter(x, mask, value, name=None):
    def f(a, m, v):
        m = torch.broadcast_to(m, a.shape)
        pos = torch.cumsum(m.reshape(-1).long(), 0) - 1
        src = v.reshape(-1)[torch.clip(pos, 0, v.numel() - 1)].reshape(
            a.shape)
        return torch.where(m, src.to(a.dtype), a)
    return apply_op("masked_scatter", f, x, mask, value)


def hstack(x, name=None):
    """numpy-compatible horizontal stack (reference tensor/manipulation.py
    hstack)."""
    def f(*arrs):
        return torch.hstack(arrs)
    return apply_op("hstack", f, *list(x))


def vstack(x, name=None):
    def f(*arrs):
        return torch.vstack(arrs)
    return apply_op("vstack", f, *list(x))


def dstack(x, name=None):
    def f(*arrs):
        return torch.dstack(arrs)
    return apply_op("dstack", f, *list(x))


def column_stack(x, name=None):
    def f(*arrs):
        return torch.column_stack(arrs)
    return apply_op("column_stack", f, *list(x))


def row_stack(x, name=None):
    return vstack(x, name)


def cartesian_prod(x, name=None):
    """Cartesian product of 1-D tensors -> [prod(N_i), k] (reference
    tensor/math.py cartesian_prod)."""
    ts = list(x)

    def f(*arrs):
        if len(arrs) == 1:          # reference returns 1-D for a single input
            return arrs[0].reshape(-1)
        grids = torch.meshgrid(*arrs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)
    return apply_op("cartesian_prod", f, *ts)


def crop(x, shape=None, offsets=None, name=None):
    """Static crop (reference tensor/creation.py crop): slice `shape` starting
    at `offsets` (defaults: offsets 0; -1 in shape = to the end)."""
    arr_shape = x.shape
    offs = [int(v) for v in (offsets if offsets is not None
                             else [0] * len(arr_shape))]
    tgt = [int(v) for v in (shape if shape is not None else arr_shape)]
    sizes = [arr_shape[i] - offs[i] if tgt[i] == -1 else tgt[i]
             for i in range(len(arr_shape))]
    # the reference's dynamic_slice clamps a start so the window fits
    offs = [min(max(o, 0), arr_shape[i] - sizes[i])
            for i, o in enumerate(offs)]

    def f(a):
        return a[tuple(slice(o, o + s) for o, s in zip(offs, sizes))]
    return apply_op("crop", f, x)


def positive(x, name=None):
    """reference tensor/math.py positive: +x (errors on bool like numpy)."""
    if unwrap(x).dtype == torch.bool:
        raise TypeError("positive is not supported for bool tensors")
    return apply_op("positive", lambda a: +a, x)


def shape(x, name=None):
    """reference paddle.shape: the RUNTIME shape as an int32 tensor."""
    b = unwrap(x)
    return Tensor(torch.tensor(list(b.shape), dtype=torch.int32,
                               device=b.device))


def numel(x, name=None):
    """reference paddle.numel: element count as a 0-D int32 tensor."""
    b = unwrap(x)
    return Tensor(torch.tensor(b.numel(), dtype=torch.int32,
                               device=b.device))


def tolist(x):
    """reference paddle.tolist (delegates to Tensor.tolist)."""
    return x.tolist() if isinstance(x, Tensor) else np.asarray(x).tolist()
