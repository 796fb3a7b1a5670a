"""Tensor creation ops: counterpart of ``paddle_tpu/ops/creation.py``
(reference: python/paddle/tensor/creation.py).

New tensors go to the current place (``core.device.current_device``: the
card unless ``set_device`` chose otherwise; without CUDA that raises).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor, _host_buf, _wrap
from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.dispatch import apply_op, unwrap


def _norm_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(unwrap(s)) if not isinstance(s, (int, np.integer)) else int(s) for s in shape)


def _dt(dtype, default=None):
    d = dtypes.convert_dtype(dtype)
    if d is None:
        d = default if default is not None else dtypes.get_default_dtype()
    return d


def _buf(x):
    """x's torch tensor; host data lands on the current place."""
    return x._buf if isinstance(x, Tensor) else (
        x if isinstance(x, torch.Tensor) else _host_buf(x))


def _scalar(v):
    v = unwrap(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    if isinstance(data, Tensor):
        t = data.astype(dtype) if dtype is not None and data.dtype != dtypes.convert_dtype(dtype) \
            else _wrap(data._buf.detach())
        t.stop_gradient = stop_gradient
        return t
    t = _wrap(_host_buf(data, dtype, place))
    if not stop_gradient:
        t.stop_gradient = False
    return t


def zeros(shape, dtype=None, name=None):
    return _wrap(torch.zeros(_norm_shape(shape), dtype=_dt(dtype),
                             device=current_device()))


def ones(shape, dtype=None, name=None):
    return _wrap(torch.ones(_norm_shape(shape), dtype=_dt(dtype),
                            device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    fill = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, (bool, int, float)):
        if isinstance(fill_value, bool):
            dtype = dtypes.bool_
        elif isinstance(fill_value, int):
            dtype = dtypes.int64
        else:
            dtype = dtypes.get_default_dtype()
    return _wrap(torch.full(_norm_shape(shape), fill, dtype=_dt(dtype),
                            device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype, name)


def zeros_like(x, dtype=None, name=None):
    return _wrap(torch.zeros_like(_buf(x), dtype=dtypes.convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return _wrap(torch.ones_like(_buf(x), dtype=dtypes.convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return _wrap(torch.full_like(_buf(x), _scalar(fill_value),
                                 dtype=dtypes.convert_dtype(dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        py = builtins.all(isinstance(v, (int, np.integer)) for v in (start, end, step))
        dtype = dtypes.int64 if py else dtypes.get_default_dtype()
    return _wrap(torch.arange(start, end, step,
                              dtype=dtypes.convert_dtype(dtype),
                              device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _wrap(torch.linspace(_scalar(start), _scalar(stop),
                                int(_scalar(num)), dtype=_dt(dtype),
                                device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _wrap(torch.logspace(_scalar(start), _scalar(stop),
                                int(_scalar(num)), base=base,
                                dtype=_dt(dtype), device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _wrap(torch.eye(num_rows, num_columns if num_columns is not None
                           else num_rows, dtype=_dt(dtype),
                           device=current_device()))


def diag(x, offset=0, padding_value=0, name=None):
    def f(a):
        d = torch.diag(a, offset)
        if a.ndim == 1 and padding_value != 0:
            mask = torch.diag(torch.ones_like(a), offset) != 0
            return torch.where(mask, d, torch.full_like(d, padding_value))
        return d
    return apply_op("diag", f, x)


def diagflat(x, offset=0, name=None):
    return apply_op("diagflat", lambda a: torch.diagflat(a, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply_op("diag_embed",
                    lambda a: torch.diag_embed(a, offset, dim1, dim2), x)


def tril(x, diagonal=0, name=None):
    return apply_op("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply_op("triu", lambda a: torch.triu(a, diagonal), x)


def tril_indices(row, col, offset=0, dtype="int64"):
    return _wrap(torch.tril_indices(row, col, offset, device=current_device()
                                    ).to(dtypes.convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _wrap(torch.triu_indices(row, col if col is not None else row,
                                    offset, device=current_device()
                                    ).to(dtypes.convert_dtype(dtype)))


def meshgrid(*args, **kwargs):
    ins = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    out = apply_op("meshgrid",
                   lambda *arrs: tuple(torch.meshgrid(*arrs, indexing="ij")),
                   *ins)
    return list(out) if isinstance(out, tuple) else [out]


def clone(x, name=None):
    return apply_op("clone", torch.clone, x)


def assign(x, output=None):
    src = unwrap(x) if isinstance(x, Tensor) else _host_buf(x)
    if output is None:
        return _wrap(src.detach())
    output._data = src.detach().to(output.dtype)
    return output


def complex(real, imag, name=None):
    return apply_op("complex", torch.complex, real, imag)


def polar(abs, angle, name=None):
    return apply_op("polar", lambda r, t: torch.complex(r * torch.cos(t),
                                                        r * torch.sin(t)),
                    abs, angle)


def create_tensor(dtype, name=None, persistable=False):
    """reference python/paddle/tensor/creation.py create_tensor."""
    return _wrap(torch.zeros((), dtype=_dt(dtype), device=current_device()))


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference python/paddle/tensor/creation.py create_parameter."""
    from ..core.tensor import Parameter
    from ..core.rng import next_generator
    dt = _dt(dtype)
    sh = _norm_shape(shape)
    dev = current_device()
    if default_initializer is not None:
        t = zeros(sh, dt)
        default_initializer(t)
        buf = t._data
    elif is_bias:
        buf = torch.zeros(sh, dtype=dt, device=dev)
    else:
        k = float(np.sqrt(6.0 / max(1, int(np.prod(sh)))))
        buf = (torch.rand(sh, generator=next_generator(dev), device=dev)
               * (2 * k) - k).to(dt)
    p = Parameter(buf)
    p.stop_gradient = False
    return p
