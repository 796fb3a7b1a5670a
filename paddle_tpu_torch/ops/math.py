"""Math ops: counterpart of ``paddle_tpu/ops/math.py`` (reference:
python/paddle/tensor/math.py; kernels phi/kernels/...).

Each op is the torch computation routed through dispatch (autograd comes
from torch). Paddle argument names (axis/keepdim/...) preserved.  A Python
scalar operand stays weakly typed, as in JAX: it becomes a 0-d tensor,
which torch's promotion ranks below a tensor of the same category
(``int32 * 2`` stays int32, ``bf16 * 2.0`` stays bf16).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..core import dtype as dtypes, sharding
from ..core.dispatch import apply_op, unwrap


def _operand(v, like, host_scalar=False):
    """A non-tensor operand of a binary op as a tensor on ``like``'s device:
    Python scalars as 0-d tensors (weakly typed), arrays narrowed to 32
    bits.  With ``host_scalar`` a Python scalar stays a 0-d tensor on the
    host, which torch's elementwise kernels read as a scalar argument: no
    copy to the card, so the op can be captured into a CUDA graph."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(v, (bool, int, float, builtins.complex)):
        return torch.tensor(v, device=None if host_scalar else dev)
    t = torch.as_tensor(np.asarray(v), device=dev)
    narrow = dtypes.NARROW.get(t.dtype)
    return t.to(narrow) if narrow is not None else t


def _tensors(fn, host_scalars=False):
    """fn over two tensors, either operand given as a scalar or array
    (``host_scalars``: for an elementwise fn, see :func:`_operand`)."""
    def f(a, b):
        if not isinstance(a, torch.Tensor):
            a = _operand(a, b, host_scalars)
        if not isinstance(b, torch.Tensor):
            b = _operand(b, a, host_scalars)
        return fn(a, b)
    return f


# ---- elementwise unary -------------------------------------------------------
def _unary(name, tfn):
    def op(x, name_=None, **kw):
        return apply_op(name, (lambda a: tfn(a, **kw)) if kw else tfn, x)
    op.__name__ = name
    return op


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
abs = _unary("abs", torch.abs)
absolute = abs
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)          # half to even, as jnp.round
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda a: a - torch.trunc(a))
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", lambda a: 1.0 / a)
neg = _unary("neg", torch.neg)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
i0 = _unary("i0", torch.special.i0)
i0e = _unary("i0e", torch.special.i0e)
i1 = _unary("i1", torch.special.i1)
i1e = _unary("i1e", torch.special.i1e)
sigmoid = _unary("sigmoid", torch.sigmoid)
logit = _unary("logit", lambda a: torch.log(a / (1 - a)))
conj = _unary("conj", torch.conj_physical)
angle = _unary("angle", torch.angle)
real = _unary("real", torch.real)
imag = _unary("imag", _imag)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op("nan_to_num",
                    lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                               neginf=neginf), x)


def clip(x, min=None, max=None, name=None):
    lo = unwrap(min) if min is not None else None
    hi = unwrap(max) if max is not None else None
    if lo is None and hi is None:
        return apply_op("clip", lambda a: a, x)
    return apply_op("clip", lambda a: torch.clamp(a, lo, hi), x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        return apply_op("lerp", lambda a, b: a + weight * (b - a), x, y)
    return apply_op("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)


isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
isneginf = _unary("isneginf", torch.isneginf)
isposinf = _unary("isposinf", torch.isposinf)
isreal = _unary("isreal", torch.isreal)


# ---- elementwise binary ------------------------------------------------------
def _binary(name, tfn):
    f = _tensors(tfn, host_scalars=True)

    def op(x, y, name_=None):
        return apply_op(name, f, x, y)
    op.__name__ = name
    return op


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)          # sign of the divisor, as jnp.mod
remainder = mod
floor_mod = mod
fmod = _binary("fmod", torch.fmod)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
hypot = _binary("hypot", torch.hypot)
logaddexp = _binary("logaddexp", torch.logaddexp)
nextafter = _binary("nextafter", torch.nextafter)
copysign = _binary("copysign", torch.copysign)
heaviside = _binary("heaviside", torch.heaviside)
ldexp = _binary("ldexp", torch.ldexp)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
inner = _binary("inner", torch.inner)


def pow(x, y, name=None):
    if isinstance(y, (int, float)):
        return apply_op("pow", lambda a: torch.pow(a, y), x)
    return apply_op("pow", _tensors(torch.pow), x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s, b = unwrap(scale), unwrap(bias)

    def like(v, a):
        """scale and bias take x's dtype, as the reference casts them"""
        if isinstance(v, torch.Tensor):
            return v.to(a.dtype)
        return float(v) if a.is_floating_point() or a.is_complex() else int(v)

    def f(a):
        sv, bv = like(s, a), like(b, a)
        return a * sv + bv if bias_after_scale else (a + bv) * sv
    return apply_op("scale", f, x)


def multiplex(inputs, index, name=None):
    idx = unwrap(index)

    def f(*ins):
        stacked = torch.stack(ins, 0)
        i = idx.reshape(1, -1, *([1] * (stacked.ndim - 2))).long()
        i = i.expand(1, *stacked.shape[1:])
        return torch.take_along_dim(stacked, i, 0)[0]
    return apply_op("multiplex", f, *inputs)


# ---- reductions --------------------------------------------------------------
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        return tuple(int(a) for a in np.atleast_1d(axis.numpy()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, ax):
    """Reduction axes as a tuple (every axis when None)."""
    if ax is None:
        return tuple(range(a.ndim))
    return ax if isinstance(ax, tuple) else (ax,)


def _one_axis_at_a_time(fn, a, ax, keepdim):
    """Reduce with a torch op that takes a single dim, over ``ax``."""
    if ax is None:
        out = fn(a.reshape(-1), 0)
        return out.reshape([1] * a.ndim) if keepdim else out
    for d in sorted((d % a.ndim for d in _dims(a, ax)), reverse=True):
        a = fn(a, d, keepdim)
    return a


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    dt = dtypes.convert_dtype(dtype)

    def f(a):
        return torch.sum(a, dim=_dims(a, ax), keepdim=keepdim, dtype=dt)
    return apply_op("sum", f, x)


def _float(a):
    return a if a.is_floating_point() or a.is_complex() else a.float()


def mean(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("mean", lambda a: torch.mean(_float(a), dim=_dims(a, ax),
                                                 keepdim=keepdim), x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax = _norm_axis(axis)
    dt = dtypes.convert_dtype(dtype)

    def f(a):
        a = a if dt is None else a.to(dt)
        return _one_axis_at_a_time(
            lambda t, d, k=False: torch.prod(t, d, keepdim=k), a, ax, keepdim)
    return apply_op("prod", f, x)


def max(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("max", lambda a: torch.amax(a, dim=_dims(a, ax),
                                                keepdim=keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("min", lambda a: torch.amin(a, dim=_dims(a, ax),
                                                keepdim=keepdim), x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("logsumexp", lambda a: torch.logsumexp(
        a, dim=_dims(a, ax), keepdim=keepdim), x)


def _flat_or(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, int(axis))


def cumsum(x, axis=None, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype)
    return apply_op("cumsum", lambda a: torch.cumsum(*_flat_or(a, axis),
                                                     dtype=dt), x)


def cumprod(x, dim=None, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype)
    return apply_op("cumprod", lambda a: torch.cumprod(*_flat_or(a, dim),
                                                       dtype=dt), x)


def cummax(x, axis=None, dtype="int64", name=None):
    def f(a):
        vals, inds = torch.cummax(*_flat_or(a, axis))
        return vals, inds.to(dtypes.convert_dtype(dtype))
    return apply_op("cummax", f, x)


def cummin(x, axis=None, dtype="int64", name=None):
    def f(a):
        vals, inds = torch.cummin(*_flat_or(a, axis))
        return vals, inds.to(dtypes.convert_dtype(dtype))
    return apply_op("cummin", f, x)


def logcumsumexp(x, axis=None, name=None):
    return apply_op("logcumsumexp",
                    lambda a: torch.logcumsumexp(*_flat_or(a, axis)), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    dt = dtypes.convert_dtype(dtype)
    return apply_op("nansum", lambda a: torch.nansum(
        a, dim=_dims(a, ax), keepdim=keepdim, dtype=dt), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("nanmean", lambda a: torch.nanmean(
        _float(a), dim=_dims(a, ax), keepdim=keepdim), x)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)

    def f(a):
        dims = _dims(a, ax)
        out = torch.count_nonzero(a, dim=dims)
        if keepdim:
            for d in sorted(d % a.ndim for d in dims):
                out = out.unsqueeze(d)
        return out
    return apply_op("count_nonzero", f, x)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def add_n(inputs, name=None):
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]

    def f(*arrs):
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out
    return apply_op("add_n", f, *ins)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b), input, x, y)


def outer(x, y, name=None):
    return apply_op("outer", torch.outer, x, y)


def kron(x, y, name=None):
    return apply_op("kron", torch.kron, x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op("diagonal", lambda a: torch.diagonal(a, offset, axis1,
                                                         axis2), x)


def dot(x, y, name=None):
    def f(a, b):
        if a.ndim == 1:
            return torch.dot(a, b)
        return torch.sum(a * b, dim=-1)
    return apply_op("dot", f, x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x:
            a = a.transpose(-1, -2) if a.ndim >= 2 else a
        if transpose_y:
            b = b.transpose(-1, -2) if b.ndim >= 2 else b
        if sharding.is_sharded(a):
            out = sharding.rows_matmul(a, b)
            if out is not None:
                return out
        return torch.matmul(a, b)
    return apply_op("matmul", f, x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return apply_op("bmm", torch.matmul, x, y)


def mv(x, vec, name=None):
    return apply_op("mv", torch.matmul, x, vec)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def softplus_op(x, beta=1, threshold=20):
    return apply_op("softplus", lambda a: torch.nn.functional.softplus(
        a * beta) / beta, x)


def increment(x, value=1.0, name=None):
    b = unwrap(x)
    x._data = b + (float(value) if b.is_floating_point() else int(value))
    return x


def all_finite(tensors):
    ok = None
    for t in tensors:
        fin = torch.isfinite(unwrap(t).float()).all()
        ok = fin if ok is None else ok & fin
    return _wrap(ok)
