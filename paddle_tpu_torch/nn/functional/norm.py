"""Normalization functionals: counterpart of
``paddle_tpu/nn/functional/norm.py`` (reference:
python/paddle/nn/functional/norm.py; rms_norm is a first-class yaml op in
the reference: phi/kernels/rms_norm_kernel.h).

All statistics accumulate in float32 whatever the input dtype, and the
result is cast back to it, as in the reference.  ``layer_norm`` is torch's
fused kernel, which normalizes a bf16 / fp16 input in float32 and rounds
once; where the weight's dtype differs from the input's it runs on float32
copies.  ``batch_norm`` in training writes the running statistics in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op, unwrap

__all__ = ["layer_norm", "rms_norm", "batch_norm", "group_norm",
           "instance_norm", "local_response_norm", "normalize"]


def _affine(out, wb, weight, bias, shape=None):
    """out * weight + bias in float32 (either may be absent), each
    reshaped to ``shape`` when given."""
    i = 0
    if weight is not None:
        w = wb[i].to(torch.float32)
        out = out * (w.reshape(shape) if shape is not None else w)
        i += 1
    if bias is not None:
        b = wb[i].to(torch.float32)
        out = out + (b.reshape(shape) if shape is not None else b)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
    ns = [int(s) for s in ns]

    def f(a, *wb):
        w = wb[0] if weight is not None else None
        b = wb[-1] if bias is not None else None
        if all(t is None or t.dtype == a.dtype for t in (w, b)):
            return TF.layer_norm(a, ns, w, b, epsilon)
        out = TF.layer_norm(a.to(torch.float32), ns,
                            None if w is None else w.to(torch.float32),
                            None if b is None else b.to(torch.float32),
                            epsilon)
        return out.to(a.dtype)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op("layer_norm", f, *args)


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1, name=None):
    def f(a, *wb):
        af = a.to(torch.float32)
        ax = begin_norm_axis if begin_norm_axis >= 0 else a.ndim + begin_norm_axis
        axes = tuple(range(ax, a.ndim))
        ms = torch.mean(torch.square(af), dim=axes, keepdim=True)
        out = af * torch.rsqrt(ms + epsilon)
        return _affine(out, wb, weight, bias).to(a.dtype)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op("rms_norm", f, *args)


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
               name=None):
    use_stats = (not training) if use_global_stats is None else use_global_stats
    ch_axis = 1 if data_format.startswith("NC") else -1
    rm, rv = unwrap(running_mean), unwrap(running_var)

    def f(a, *wb):
        nd = a.ndim
        cax = ch_axis % nd
        red_axes = tuple(i for i in range(nd) if i != cax)
        af = a.to(torch.float32)
        if use_stats:
            mean, var = rm.to(torch.float32), rv.to(torch.float32)
        else:
            mean = torch.mean(af, dim=red_axes)
            var = torch.var(af, dim=red_axes, correction=0)
        shape = [1] * nd
        shape[cax] = a.shape[cax]
        out = (af - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
        # the batch stats come back too, so the running update reuses them
        return _affine(out, wb, weight, bias, shape).to(a.dtype), mean, var
    args = [x] + [t for t in (weight, bias) if t is not None]
    out, bmean, bvar = apply_op("batch_norm", f, *args)
    if training and not use_stats:
        with torch.no_grad():
            rm.copy_(momentum * rm.to(torch.float32)
                     + (1 - momentum) * unwrap(bmean).detach())
            rv.copy_(momentum * rv.to(torch.float32)
                     + (1 - momentum) * unwrap(bvar).detach())
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None, data_format="NCHW",
               name=None):
    def f(a, *wb):
        chan_last = not data_format.startswith("NC")
        a_ = torch.movedim(a, -1, 1) if chan_last else a
        n, c = a_.shape[0], a_.shape[1]
        spatial = a_.shape[2:]
        af = a_.to(torch.float32).reshape(n, num_groups, c // num_groups, *spatial)
        axes = tuple(range(2, af.ndim))
        mean = torch.mean(af, dim=axes, keepdim=True)
        var = torch.var(af, dim=axes, keepdim=True, correction=0)
        out = ((af - mean) * torch.rsqrt(var + epsilon)).reshape(n, c, *spatial)
        shape = [1] * out.ndim
        shape[1] = c
        out = _affine(out, wb, weight, bias, shape).to(a.dtype)
        return torch.movedim(out, 1, -1) if chan_last else out
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op("group_norm", f, *args)


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW",
                  name=None):
    def f(a, *wb):
        nd = a.ndim
        cax = 1 if data_format.startswith("NC") else nd - 1
        red_axes = tuple(range(2, nd)) if cax == 1 else tuple(range(1, nd - 1))
        af = a.to(torch.float32)
        mean = torch.mean(af, dim=red_axes, keepdim=True)
        var = torch.var(af, dim=red_axes, keepdim=True, correction=0)
        out = (af - mean) * torch.rsqrt(var + eps)
        shape = [1] * nd
        shape[cax] = a.shape[cax]
        return _affine(out, wb, weight, bias, shape).to(a.dtype)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op("instance_norm", f, *args)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None):
    def f(a):
        cax = 1 if data_format.startswith("NC") else a.ndim - 1
        sq = torch.square(a.to(torch.float32))
        c = a.shape[cax]
        half = size // 2
        pads = [0, 0] * a.ndim
        # torch's pad list runs from the last dim backwards
        pads[2 * (a.ndim - 1 - cax)] = half
        pads[2 * (a.ndim - 1 - cax) + 1] = size - half - 1
        sq_p = TF.pad(sq, pads)
        acc = torch.zeros_like(sq)
        for i in range(size):
            acc = acc + torch.narrow(sq_p, cax, i, c)
        return (a.to(torch.float32) / torch.pow(k + alpha * acc, beta)).to(a.dtype)
    return apply_op("local_response_norm", f, x)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def f(a):
        af = a.to(torch.float32)
        nrm = torch.pow(torch.sum(torch.pow(torch.abs(af), p), dim=axis,
                                  keepdim=True), 1.0 / p)
        return (af / torch.clamp(nrm, min=epsilon)).to(a.dtype)
    return apply_op("normalize", f, x)
