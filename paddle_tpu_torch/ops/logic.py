"""Comparison / logical / bitwise ops: counterpart of
``paddle_tpu/ops/logic.py`` (reference: python/paddle/tensor/logic.py)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, _wrap
from ..core.dispatch import apply_op, unwrap
from .math import _tensors


def _cmp(name, tfn):
    # through dispatch; bool outputs get stop_gradient=True automatically
    f = _tensors(tfn, host_scalars=True)

    def op(x, y, name_=None):
        return apply_op(name, f, x, y)
    op.__name__ = name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)

logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _cmp("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _cmp("bitwise_right_shift", torch.bitwise_right_shift)


def logical_not(x, out=None, name=None):
    return apply_op("logical_not", torch.logical_not, x)


def bitwise_not(x, out=None, name=None):
    return apply_op("bitwise_not", torch.bitwise_not, x)


def _array_equal(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (a == b).all()


def equal_all(x, y, name=None):
    return apply_op("equal_all", _tensors(_array_equal), x, y)


def is_empty(x, name=None):
    return _wrap(torch.tensor(x.size == 0, device=unwrap(x).device))


def _reduce_bool(tfn, a, axis, keepdim):
    if axis is None:
        out = tfn(a)
        return out.reshape([1] * a.ndim) if keepdim else out
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return tfn(a, dim=dims, keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return apply_op("all", lambda a: _reduce_bool(torch.all, a, axis,
                                                  keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    return apply_op("any", lambda a: _reduce_bool(torch.any, a, axis,
                                                  keepdim), x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op("isclose", _tensors(lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)), x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op("allclose", _tensors(lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan).all()), x, y)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return apply_op("nonzero", lambda c: torch.nonzero(c, as_tuple=True),
                        condition)
    cond = unwrap(condition)

    def f(a, b):
        c = cond if isinstance(cond, torch.Tensor) else torch.as_tensor(
            cond, device=(a if isinstance(a, torch.Tensor) else b).device)
        return torch.where(c, a, b)
    return apply_op("where", f, x, y)


def where_(condition, x, y, name=None):
    out = where(condition, x, y)
    x._data = out._data
    return x


def is_tensor(x):
    return isinstance(x, Tensor)
