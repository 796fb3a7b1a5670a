"""Op surface assembly + Tensor method installation: counterpart of
``paddle_tpu/ops/__init__.py``.

Reference analog: the monkey-patch of generated methods onto the eager Tensor type
(python/paddle/base/dygraph/math_op_patch.py + tensor/__init__.py method lists).
The method lists are the reference's, and every name on them has its op
here (the reference's installer skips a missing one, ``getattr(mod, name,
None)``, and so does this one).

The hand-written CUDA kernels' wrappers sit beside the op modules, each in
its own module (``flash_attention``, ``paged_attention``,
``quant_matmul``), imported where they are used.
"""
from __future__ import annotations

import builtins
import operator

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from . import (creation, math, manipulation, logic, linalg, search, random,
               stat, math_extra, manip_extra, linalg_extra)
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .math_extra import *  # noqa: F401,F403
from .manip_extra import *  # noqa: F401,F403
from .linalg_extra import *  # noqa: F401,F403
from .einsum_op import einsum  # noqa: F401
from .math import _operand, _tensors


# ---- indexing ----------------------------------------------------------------
def _prep_index(item, device):
    """Convert an indexing object: Tensors and arrays to torch tensors
    (integers as int64), slices/ints/None/Ellipsis as they are."""
    if isinstance(item, tuple):
        return tuple(_prep_index(i, device) for i in item)
    if isinstance(item, (Tensor, torch.Tensor, list, np.ndarray)):
        return manipulation._index(item, device)
    return item


def _getitem(self, item):
    idx = _prep_index(item, self._buf.device)
    return apply_op("getitem", lambda a: a[idx], self)


def _check_inplace(t):
    """Paddle refuses an in-place op on a leaf that requires grad while grad
    is recorded (its gradient would have nowhere to go)."""
    b = t._buf
    if b.requires_grad and b.grad_fn is None and torch.is_grad_enabled():
        raise RuntimeError(
            f"Leaf Tensor {t.name or ''} that doesn't stop gradient can't use "
            "inplace strategy (run it under no_grad())")


def _assigned(a, idx, v):
    out = a.clone()
    out[idx] = v
    return out


def _setitem(self, item, value):
    _check_inplace(self)
    idx = _prep_index(item, self._buf.device)
    if isinstance(value, Tensor):
        out = apply_op("setitem", lambda a, v: _assigned(a, idx, v.to(a.dtype)),
                       self, value)
    else:
        out = apply_op("setitem", lambda a: _assigned(
            a, idx, value if np.isscalar(value) else
            _operand(value, a).to(a.dtype)), self)
    self._data = out._data


def _iter(self):
    for i in range(len(self)):
        yield self[i]


# ---- astype ------------------------------------------------------------------
def _astype(self, dtype):
    return manipulation.cast(self, dtype)


# ---- operator overloads ------------------------------------------------------
def _scalar(o):
    """A Python-side operand: scalars as they are (torch keeps them weakly
    typed), arrays as host data for ``_operand``."""
    if isinstance(o, (bool, int, float, builtins.complex)):
        return o
    if isinstance(o, np.generic):
        return o.item()
    return np.asarray(o)


def _coerce_scalar_op(name, fwd):
    def f(self, other):
        if isinstance(other, Tensor):
            return apply_op(name, fwd, self, other)
        o = _scalar(other)
        if isinstance(o, np.ndarray):
            return apply_op(name, lambda a: fwd(a, _operand(o, a)), self)
        return apply_op(name, lambda a: fwd(a, o), self)

    def fr(self, other):
        o = _scalar(other)
        if isinstance(o, np.ndarray):
            return apply_op(name, lambda a: fwd(_operand(o, a), a), self)
        return apply_op(name, lambda a: fwd(o, a), self)
    return f, fr


_add, _radd = _coerce_scalar_op("add", operator.add)
_sub, _rsub = _coerce_scalar_op("subtract", operator.sub)
_mul, _rmul = _coerce_scalar_op("multiply", operator.mul)
_div, _rdiv = _coerce_scalar_op("divide", operator.truediv)
_fdiv, _rfdiv = _coerce_scalar_op("floor_divide", operator.floordiv)
_mod, _rmod = _coerce_scalar_op("mod", operator.mod)
_pow, _rpow = _coerce_scalar_op("pow", operator.pow)
_mat, _rmat = _coerce_scalar_op("matmul", operator.matmul)


def _neg(self):
    return math.neg(self)


def _abs(self):
    return math.abs(self)


def _invert(self):
    return logic.bitwise_not(self) if self.dtype != torch.bool else logic.logical_not(self)


def _cmp_method(name, tfn):
    f = _tensors(tfn, host_scalars=True)

    def m(self, other):
        return apply_op(name, f, self, other)
    return m


def _inplace_from(fn):
    def f(self, *args, **kw):
        _check_inplace(self)
        out = fn(self, *args, **kw)
        self._data = out._data
        return self
    return f


_METHODS = {
    # dunder
    "__getitem__": _getitem, "__setitem__": _setitem, "__iter__": _iter,
    "__add__": _add, "__radd__": _radd, "__sub__": _sub, "__rsub__": _rsub,
    "__mul__": _mul, "__rmul__": _rmul, "__truediv__": _div, "__rtruediv__": _rdiv,
    "__floordiv__": _fdiv, "__rfloordiv__": _rfdiv, "__mod__": _mod, "__rmod__": _rmod,
    "__pow__": _pow, "__rpow__": _rpow, "__matmul__": _mat, "__rmatmul__": _rmat,
    "__neg__": _neg, "__abs__": _abs, "__invert__": _invert,
    "__eq__": _cmp_method("equal", torch.eq),
    "__ne__": _cmp_method("not_equal", torch.ne),
    "__lt__": _cmp_method("less", torch.lt),
    "__le__": _cmp_method("less_equal", torch.le),
    "__gt__": _cmp_method("greater", torch.gt),
    "__ge__": _cmp_method("greater_equal", torch.ge),
    "__and__": _cmp_method("logical_and", torch.logical_and),
    "__or__": _cmp_method("logical_or", torch.logical_or),
    "__xor__": _cmp_method("logical_xor", torch.logical_xor),
    "astype": _astype, "cast": _astype,
}

# plain methods delegating to module-level ops (x.method(...) == ops.method(x, ...))
_DELEGATED = [
    # math
    "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt", "rsqrt", "abs", "sign",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
    "acosh", "atanh", "floor", "ceil", "round", "trunc", "frac", "square",
    "reciprocal", "neg", "erf", "erfinv", "lgamma", "digamma", "sigmoid", "logit",
    "conj", "angle", "real", "imag", "nan_to_num", "clip", "lerp", "isnan", "isinf",
    "isfinite", "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "fmod", "maximum", "minimum", "fmax", "fmin", "atan2", "pow",
    "scale", "sum", "mean", "prod", "max", "min", "amax", "amin", "logsumexp",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "nansum", "nanmean",
    "count_nonzero", "addmm", "outer", "kron", "trace", "diagonal", "dot", "matmul",
    "mm", "bmm", "mv", "inner",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than", "less_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "equal_all", "all", "any", "isclose",
    "allclose", "where",
    # manipulation
    "reshape", "reshape_", "transpose", "transpose_", "moveaxis", "swapaxes",
    "t", "squeeze",
    "unsqueeze", "split", "chunk", "unbind", "flatten", "tile", "expand",
    "broadcast_to", "expand_as", "flip", "rot90", "roll", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "index_select", "index_add", "index_put",
    "scatter", "scatter_nd_add", "repeat_interleave", "unfold", "masked_fill",
    "fill_diagonal", "unique", "unique_consecutive", "masked_select", "view",
    "tensordot", "as_complex", "as_real", "cast",
    # linalg
    "norm", "dist", "cross", "cholesky", "inverse", "pinv", "solve", "matrix_power",
    "det", "bincount", "histogram",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "nonzero",
    "index_sample", "bucketize",
    # stat
    "var", "std", "median", "nanmedian", "quantile", "nanquantile",
    # creation
    "tril", "triu", "diag", "clone",
    # math_extra
    "sinc", "signbit", "gammaln", "gammainc", "gammaincc", "multigammaln",
    "polygamma", "diff", "sgn", "frexp", "trapezoid", "cumulative_trapezoid",
    "vander", "renorm", "isin", "histogram_bin_edges", "reduce_as",
    "vecdot", "combinations", "pdist",
    # manip_extra
    "reverse", "less", "bitwise_invert", "tensor_split", "hsplit", "vsplit",
    "dsplit", "unstack", "take", "unflatten", "as_strided", "view_as",
    "matrix_transpose", "rank", "is_complex", "is_integer", "is_floating_point",
    "slice_scatter", "select_scatter", "diagonal_scatter", "index_fill",
    "masked_scatter",
    # linalg_extra
    "lu", "lu_unpack", "ormqr", "cond", "cholesky_inverse", "cdist",
    # random extras
    "top_p_sampling", "cauchy_", "geometric_", "log_normal_", "uniform_",
    "normal_", "exponential_",
]

_INPLACE = {
    "add_": math.add, "subtract_": math.subtract, "multiply_": math.multiply,
    "divide_": math.divide, "scale_": math.scale, "clip_": math.clip,
    "floor_": math.floor, "ceil_": math.ceil, "round_": math.round,
    "exp_": math.exp, "sqrt_": math.sqrt, "rsqrt_": math.rsqrt,
    "reciprocal_": math.reciprocal, "tanh_": math.tanh, "sigmoid_": math.sigmoid,
    "abs_": math.abs, "neg_": math.neg, "pow_": math.pow, "remainder_": math.mod,
    "lerp_": math.lerp, "squeeze_": manipulation.squeeze,
    "unsqueeze_": manipulation.unsqueeze, "flatten_": manipulation.flatten,
    "masked_fill_": manipulation.masked_fill, "index_put_": manipulation.index_put,
    "fill_diagonal_": manipulation.fill_diagonal, "cast_": manipulation.cast,
    "scatter_": manipulation.scatter, "where_": logic.where,
}

# the remaining in-place tensor_method_func surface is mechanical: `name_`
# computes out-of-place then rebinds the buffer (reference inplace codegen,
# paddle/fluid/pybind/eager_generator: *_ apis)
_AUTO_INPLACE = [
    "asin", "cumsum", "cumprod", "logit", "log", "log2", "log10", "square",
    "multigammaln", "nan_to_num", "hypot", "floor_divide", "mod", "log1p",
    "addmm", "lgamma", "gammaincc", "gammainc", "equal", "greater_equal",
    "greater_than", "less_equal", "less_than", "less", "logical_and",
    "logical_not", "logical_or", "logical_xor", "not_equal", "tan", "gammaln",
    "digamma", "trunc", "frac", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_invert", "atanh", "gcd", "lcm", "erfinv",
    "put_along_axis", "ldexp", "i0", "polygamma", "renorm", "tril", "triu",
    "acos", "atan", "cos", "cosh", "sin", "sinc", "sinh", "acosh", "asinh",
    "copysign", "bitwise_left_shift", "bitwise_right_shift", "index_fill",
    "masked_scatter", "t", "erf", "expm1",
]


def _set_(self, source, name=None):
    """x.set_(y): rebind x's buffer/shape/dtype to y's (reference set_ op)."""
    self._data = source._data if isinstance(source, Tensor) else \
        _operand(source, self._buf)
    return self


def _fill_(self, value):
    self._data = torch.full_like(self._buf, value)
    return self


def _zero_(self):
    self._data = torch.zeros_like(self._buf)
    return self


def _set_value(self, value):
    v = value._data if isinstance(value, Tensor) else _operand(value, self._buf)
    self._data = v.to(self._buf.dtype).reshape(self._buf.shape)
    return self


def _install():
    import sys
    mod = sys.modules[__name__]
    for name, fn in _METHODS.items():
        setattr(Tensor, name, fn)
    for name in _DELEGATED:
        fn = getattr(mod, name, None)
        if fn is None:
            continue

        def make(f):
            def m(self, *a, **k):
                return f(self, *a, **k)
            return m
        setattr(Tensor, name, make(fn))
    for name, fn in _INPLACE.items():
        setattr(Tensor, name, _inplace_from(fn))
        setattr(mod, name, _inplace_from(fn))   # paddle.abs_(t) module form
    for base in _AUTO_INPLACE:
        fn = getattr(mod, base, None)
        if fn is not None:
            setattr(Tensor, base + "_", _inplace_from(fn))
            setattr(mod, base + "_", _inplace_from(fn))
    # paddle name quirk: floor_mod_ aliases mod_
    Tensor.floor_mod_ = Tensor.mod_
    mod.floor_mod_ = mod.remainder_
    Tensor.set_ = _set_
    for name in ("uniform_", "normal_", "exponential_", "bernoulli_",
                 "cauchy_", "geometric_", "log_normal_"):
        setattr(Tensor, name, getattr(random, name))
    Tensor.fill_ = _fill_
    Tensor.zero_ = _zero_
    Tensor.set_value = _set_value


_install()
