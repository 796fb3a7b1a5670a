"""Functional differentiation API — jacobian / hessian: counterpart of
``paddle_tpu/autograd/functional.py`` (reference:
python/paddle/autograd/autograd.py Jacobian:L~30, Hessian, exported via
python/paddle/autograd/__init__.py:26).

Tape-native: rows are computed with `grad(create_graph=...)` sweeps over the
recorded graph (torch's), so jacobian composes with the rest of eager
autograd (and hessian is literally jacobian-of-jacobian).
"""
from __future__ import annotations

import numpy as np

from ..core.tensor import Tensor
from .backward import grad as _grad


def _flat_size(t: Tensor, batch_axis):
    shape = list(t.shape)
    if batch_axis is not None:
        shape.pop(batch_axis)
    return int(np.prod(shape)) if shape else 1


def _row_grad(y_elem, xs, create_graph):
    return _grad([y_elem], xs, retain_graph=True, create_graph=create_graph,
                 allow_unused=True)


def jacobian(ys, xs, batch_axis=None, create_graph=False):
    """J[i, j] = d ys_flat[i] / d xs_flat[j].

    ys, xs: Tensor or list of Tensors. With batch_axis=0 (the only supported
    batch axis, matching the reference), ys/xs are [B, *] and the result is
    [B, ny, nx] — batch elements are assumed independent (the reference's
    contract). Returns a Tensor for single ys/xs, nested lists otherwise."""
    single_y = isinstance(ys, Tensor)
    single_x = isinstance(xs, Tensor)
    ys_l = [ys] if single_y else list(ys)
    xs_l = [xs] if single_x else list(xs)
    if batch_axis not in (None, 0):
        raise ValueError("batch_axis must be None or 0")

    from .. import ops

    out_rows = []
    for y in ys_l:
        ny = _flat_size(y, batch_axis)
        if batch_axis is None:
            y_flat = y.reshape([-1])
        else:
            y_flat = y.reshape([y.shape[0], -1])
        rows = []       # rows[i] = tuple over xs of grad arrays
        for i in range(ny):
            y_i = y_flat[i] if batch_axis is None else y_flat[:, i].sum()
            gs = _row_grad(y_i, xs_l, create_graph)
            row = []
            for x, g in zip(xs_l, gs):
                if g is None:
                    g = ops.zeros_like(x)
                if batch_axis is None:
                    row.append(g.reshape([-1]))
                else:
                    row.append(g.reshape([g.shape[0], -1]))
            rows.append(row)
        per_x = []
        for k, x in enumerate(xs_l):
            stacked = ops.stack([r[k] for r in rows],
                                axis=0 if batch_axis is None else 1)
            per_x.append(stacked)   # [ny, nx] or [B, ny, nx]
        out_rows.append(per_x)

    if single_y and single_x:
        return out_rows[0][0]
    if single_y:
        return out_rows[0]
    if single_x:
        return [r[0] for r in out_rows]
    return out_rows


def hessian(ys, xs, batch_axis=None):
    """H[i, j] = d^2 ys / d xs_i d xs_j for scalar ys (per batch element when
    batch_axis=0). Implemented as jacobian of a create_graph jacobian."""
    single_x = isinstance(xs, Tensor)
    xs_l = [xs] if single_x else list(xs)
    if not isinstance(ys, Tensor):
        raise TypeError("hessian expects a single (scalar) output tensor")
    n_scalar = _flat_size(ys, batch_axis)
    if n_scalar != 1:
        raise ValueError("hessian needs a scalar ys (per batch element)")
    first = jacobian(ys, xs_l, batch_axis=batch_axis, create_graph=True)
    # first[i] is [1, nx_i] ([B, 1, nx_i] batched); flattening inside the
    # second jacobian makes block H[i][j] = [nx_i, nx_j] ([B, nx_i, nx_j])
    out = [jacobian(g, xs_l, batch_axis=batch_axis) for g in first]
    if single_x:
        return out[0][0]
    return out
