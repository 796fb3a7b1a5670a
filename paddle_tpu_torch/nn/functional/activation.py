"""Activation functionals: counterpart of
``paddle_tpu/nn/functional/activation.py`` (reference:
python/paddle/nn/functional/activation.py).

Each is one ``apply_op`` dispatch of torch ops with the reference's
formula and constants (``hardsigmoid``'s slope 0.1666667, ``softplus``'s
threshold, ``selu``'s scale and alpha).  ``gelu(approximate=True)`` is
torch's tanh GELU, computed in float32 inside its kernel for a bf16 input.
The random ones (``gumbel_softmax``, ``rrelu`` in training) draw from the
global generator on the input's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op, unwrap
from ...core.dtype import convert_dtype
from ...core.rng import next_generator

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
           "hardsigmoid", "hardswish", "hardtanh", "leaky_relu",
           "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "relu",
           "relu6", "relu_", "rrelu", "selu", "sigmoid", "silu", "softmax",
           "softmax_", "softplus", "softshrink", "softsign", "swiglu",
           "swish", "tanh", "tanhshrink", "thresholded_relu"]


def _act(name, tfn):
    def op(x, name_=None, **kw):
        return apply_op(name, (lambda a: tfn(a, **kw)) if kw else tfn, x)
    op.__name__ = name
    return op


relu = _act("relu", torch.relu)
relu6 = _act("relu6", TF.relu6)
relu_ = relu
sigmoid = _act("sigmoid", torch.sigmoid)
tanh = _act("tanh", torch.tanh)
silu = _act("silu", TF.silu)
swish = silu
mish = _act("mish", TF.mish)
softsign = _act("softsign", TF.softsign)
tanhshrink = _act("tanhshrink", lambda a: a - torch.tanh(a))
log_sigmoid = _act("log_sigmoid", TF.logsigmoid)


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return apply_op("gelu", lambda a: TF.gelu(a, approximate=mode), x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op("leaky_relu", lambda a: TF.leaky_relu(a, negative_slope), x)


def elu(x, alpha=1.0, name=None):
    return apply_op("elu", lambda a: TF.elu(a, alpha), x)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), x)


def celu(x, alpha=1.0, name=None):
    return apply_op("celu", lambda a: TF.celu(a, alpha), x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op("hardtanh", lambda a: torch.clamp(a, min, max), x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op("hardsigmoid",
                    lambda a: torch.clamp(a * slope + offset, 0.0, 1.0), x)


def hardswish(x, name=None):
    return apply_op("hardswish",
                    lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x)


def hardshrink(x, threshold=0.5, name=None):
    return apply_op("hardshrink", lambda a: torch.where(
        torch.abs(a) > threshold, a, 0.0), x)


def softshrink(x, threshold=0.5, name=None):
    return apply_op("softshrink", lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, 0.0)), x)


def softplus(x, beta=1, threshold=20, name=None):
    return apply_op("softplus", lambda a: torch.where(
        a * beta > threshold, a,
        torch.logaddexp(a * beta, torch.zeros((), dtype=a.dtype,
                                              device=a.device)) / beta), x)


def softmax(x, axis=-1, dtype=None, name=None):
    dt = convert_dtype(dtype)

    def f(a):
        if dt is not None:
            a = a.to(dt)
        return torch.softmax(a, dim=axis)
    return apply_op("softmax", f, x)


softmax_ = softmax


def log_softmax(x, axis=-1, dtype=None, name=None):
    dt = convert_dtype(dtype)

    def f(a):
        if dt is not None:
            a = a.to(dt)
        return torch.log_softmax(a, dim=axis)
    return apply_op("log_softmax", f, x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    gen = next_generator(unwrap(x).device)

    def f(a):
        u = torch.rand(a.shape, generator=gen, device=a.device)
        g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = y_hard - y.detach() + y
        return y
    return apply_op("gumbel_softmax", f, x)


def prelu(x, weight, data_format="NCHW", name=None):
    def f(a, w):
        if w.numel() == 1:
            return torch.where(a > 0, a, w.reshape(()) * a)
        ch_axis = 1 if data_format == "NCHW" else a.ndim - 1
        shape = [1] * a.ndim
        shape[ch_axis] = w.numel()
        return torch.where(a > 0, a, w.reshape(shape) * a)
    return apply_op("prelu", f, x, weight)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, name=None):
    if training:
        gen = next_generator(unwrap(x).device)

        def f(a):
            slope = (torch.rand(a.shape, generator=gen, device=a.device)
                     * (upper - lower) + lower).to(a.dtype)
            return torch.where(a >= 0, a, slope * a)
        return apply_op("rrelu", f, x)
    mid = (lower + upper) / 2
    return apply_op("rrelu", lambda a: torch.where(a >= 0, a, mid * a), x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op("thresholded_relu",
                    lambda a: torch.where(a > threshold, a, value), x)


def maxout(x, groups, axis=1, name=None):
    def f(a):
        ax = axis % a.ndim
        c = a.shape[ax]
        new_shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(new_shape), dim=ax + 1)
    return apply_op("maxout", f, x)


def glu(x, axis=-1, name=None):
    def f(a):
        a1, a2 = torch.chunk(a, 2, dim=axis)
        return a1 * torch.sigmoid(a2)
    return apply_op("glu", f, x)


def swiglu(x, y=None, name=None):
    """LLM gate activation — first-class yaml op in the reference
    (phi/kernels/swiglu_kernel.h)."""
    if y is None:
        def f(a):
            a1, a2 = torch.chunk(a, 2, dim=-1)
            return TF.silu(a1) * a2
        return apply_op("swiglu", f, x)
    return apply_op("swiglu", lambda a, b: TF.silu(a) * b, x, y)
