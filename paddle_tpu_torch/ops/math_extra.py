"""Math ops closing the paddle.tensor surface gap: counterpart of
``paddle_tpu/ops/math_extra.py`` (reference: python/paddle/tensor/math.py —
sinc, gammainc family, diff, trapezoid, vander, renorm, isin, histogram
family, reduce_as, block_diag; kernels under phi/kernels/*).  Each op is
one ``apply_op`` of torch math with the reference's semantics."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from . import math as _math


def sinc(x, name=None):
    return apply_op("sinc", torch.sinc, x)


def signbit(x, name=None):
    return apply_op("signbit", torch.signbit, x)


gammaln = _math.lgamma


def gammainc(x, y, name=None):
    return apply_op("gammainc", torch.special.gammainc, x, y)


def gammaincc(x, y, name=None):
    return apply_op("gammaincc", torch.special.gammaincc, x, y)


def multigammaln(x, p, name=None):
    return apply_op("multigammaln",
                    lambda a: torch.special.multigammaln(a, p), x)


def polygamma(x, n, name=None):
    return apply_op("polygamma",
                    lambda a: torch.special.polygamma(n, a), x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    args = [t for t in (prepend, append) if isinstance(t, Tensor)]

    def f(a, *rest):
        pre = rest[0] if isinstance(prepend, Tensor) else prepend
        app = rest[-1] if isinstance(append, Tensor) else append
        pre, app = (None if v is None else torch.as_tensor(
            v, dtype=a.dtype, device=a.device) for v in (pre, app))
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)

    return apply_op("diff", f, x, *args)


def sgn(x, name=None):
    def f(a):
        if a.is_complex():
            mag = torch.abs(a)
            return torch.where(mag == 0, 0, a / torch.where(mag == 0, 1, mag))
        return torch.sign(a)
    return apply_op("sgn", f, x)


def frexp(x, name=None):
    def f(a):
        m, e = torch.frexp(a)
        return m, e.to(a.dtype)
    return apply_op("frexp", f, x)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op("trapezoid",
                        lambda a, b: torch.trapezoid(a, b, dim=axis), y, x)
    return apply_op("trapezoid",
                    lambda a: torch.trapezoid(a, dx=1.0 if dx is None else dx,
                                              dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def _cum(a, spacing):
        a0 = torch.movedim(a, axis, -1)
        avg = (a0[..., 1:] + a0[..., :-1]) / 2.0
        out = torch.cumsum(avg * spacing, dim=-1)
        return torch.movedim(out, -1, axis)

    if x is not None:
        def f(a, b):
            b0 = torch.movedim(b, axis, -1) if b.ndim == a.ndim else b
            d = torch.diff(b0, dim=-1 if b.ndim == a.ndim else 0)
            if b.ndim != a.ndim:  # 1-D sample positions broadcast along axis
                shape = [1] * a.ndim
                shape[axis if axis >= 0 else a.ndim + axis] = -1
                d = d.reshape(shape)
                d = torch.movedim(d, axis, -1)
            return _cum(a, d)
        return apply_op("cumulative_trapezoid", f, y, x)
    return apply_op("cumulative_trapezoid",
                    lambda a: _cum(a, 1.0 if dx is None else dx), y)


def vander(x, n=None, increasing=False, name=None):
    return apply_op("vander",
                    lambda a: torch.linalg.vander(a, N=n) if increasing
                    else torch.linalg.vander(a, N=n).flip(-1), x)


def renorm(x, p, axis, max_norm, name=None):
    def f(a):
        moved = torch.movedim(a, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
        out = flat * scale[:, None]
        return torch.movedim(out.reshape(moved.shape), 0, axis)
    return apply_op("renorm", f, x)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply_op("isin",
                    lambda a, b: torch.isin(a, b, assume_unique=assume_unique,
                                            invert=invert), x, test_x)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    """numpy's ``histogram_bin_edges`` for an integer bin count: ``bins + 1``
    even edges over [min, max], the data's range when both are 0, widened
    by 0.5 each way where the range is empty."""
    def f(a):
        if min == 0 and max == 0:
            lo, hi = float(a.min()), float(a.max())
        else:
            lo, hi = float(min), float(max)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        dt = a.dtype if a.is_floating_point() else torch.get_default_dtype()
        return torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                              device=a.device).to(dt)
    return apply_op("histogram_bin_edges", f, input)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    """numpy's ``histogramdd`` of the sample on the host: (hist, [edges])."""
    xs = x.numpy()
    w = weights.numpy() if isinstance(weights, Tensor) else weights
    hist, edges = np.histogramdd(xs, bins=bins, range=ranges,
                                 density=density, weights=w)
    dev = unwrap(x).device
    return (Tensor(torch.as_tensor(hist.astype(np.float32), device=dev)),
            [Tensor(torch.as_tensor(e.astype(np.float32), device=dev))
             for e in edges])


def reduce_as(x, target, name=None):
    """Sum-reduce x to target's shape (reference reduce_as op)."""
    tshape = tuple(target.shape) if isinstance(target, Tensor) else tuple(target)

    def f(a):
        extra = a.ndim - len(tshape)
        if extra:
            a = torch.sum(a, dim=tuple(range(extra)))
        keep = tuple(i for i, (s, t) in enumerate(zip(a.shape, tshape))
                     if s != t)
        if keep:
            a = torch.sum(a, dim=keep, keepdim=True)
        return a
    return apply_op("reduce_as", f, x)


def block_diag(inputs, name=None):
    return apply_op("block_diag",
                    lambda *arrs: torch.block_diag(*arrs), *inputs)


def vecdot(x, y, axis=-1, name=None):
    """reference: paddle.linalg.vecdot (ops.yaml vecdot)."""
    def f(a, b):
        return torch.sum(a * b, dim=axis)
    return apply_op("vecdot", f, x, y)


def combinations(x, r=2, with_replacement=False, name=None):
    """reference: paddle.combinations (itertools semantics over a 1-D
    tensor). Index set is static (host-side), the gather is device-side."""
    n = x.shape[0]
    idx = list(itertools.combinations_with_replacement(range(n), r)
               if with_replacement else itertools.combinations(range(n), r))
    if not idx:
        b = unwrap(x)
        return Tensor(torch.zeros((0, r), dtype=b.dtype, device=b.device))

    def f(a):
        return a[torch.as_tensor(idx, device=a.device)]
    return apply_op("combinations", f, x)


def pdist(x, p=2.0, name=None):
    """reference: paddle.pdist — condensed pairwise distances of [N, D]."""
    n = x.shape[0]

    def f(a):
        iu = torch.triu_indices(n, n, offset=1, device=a.device)
        # gather the i<j pairs FIRST: the full [n, n] matrix has sqrt(0) on
        # the diagonal whose vjp is inf -> 0*inf = NaN even though discarded
        d = torch.abs(a[iu[0]] - a[iu[1]])       # [npairs, D]
        if p == 2.0:
            return torch.sqrt(torch.sum(d * d, -1))
        if p == 0:
            return torch.sum(d != 0, -1).to(a.dtype)
        if p == float("inf"):
            return torch.amax(d, -1)
        return torch.sum(d ** p, -1) ** (1.0 / p)
    return apply_op("pdist", f, x)
