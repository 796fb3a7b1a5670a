"""Common functionals: counterpart of ``paddle_tpu/nn/functional/common.py``
(reference: python/paddle/nn/functional/common.py, input.py).

linear, dropout and friends, embedding, one_hot, pad, cosine_similarity,
bilinear, label_smooth, interpolate / upsample, unfold / fold and the pixel
and channel shuffles, each one ``apply_op`` of torch ops with the
reference's conventions: ``linear``'s weight is ``[in, out]``; a dropout
at ``p == 0`` returns its input unchanged; ``interpolate`` resizes as
``jax.image.resize`` does (half-pixel centres, antialiased linear / cubic
weights, cubic with Keys' a = -0.5, nearest by ``floor((i + 0.5) * in /
out)``); ``embedding(sparse=True)``, whose gradient the reference makes a
``SelectedRows``, is refused where that gradient would be formed.  Random
masks draw from the global generator on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor, _wrap
from ...core import sharding
from ...core.dispatch import apply_op, unwrap
from ...core.rng import next_generator
from ...ops.manipulation import pad


def _linear(a, w, b=None):
    """x @ W (+ b) with W [in, out]; with a bias one GEMM whose epilogue
    adds it (``addmm`` over the rows of x).  Activations split along a
    sequence multiply on each rank's rows (``sharding.rows_matmul``)."""
    if sharding.is_sharded(a):
        out = sharding.rows_matmul(a, w)
        if out is not None:
            return out if b is None else out + b
    if b is None or a.ndim < 2:
        out = torch.matmul(a, w)
        return out if b is None else out + b
    out = torch.addmm(b, a.reshape(-1, a.shape[-1]), w)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b; W is [in, out] (paddle convention)."""
    if bias is None:
        return apply_op("linear", _linear, x, weight)
    return apply_op("linear", _linear, x, weight, bias)


def _keep_mask(a, p, shape):
    return torch.rand(shape, generator=next_generator(a.device),
                      device=a.device) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    if not training or p == 0.0:
        if p != 0.0 and mode == "downscale_in_infer":
            # downscale_in_infer contract: train masks unscaled, infer scales by (1-p)
            return apply_op("dropout", lambda a: a * (1.0 - p), x)
        return x if isinstance(x, Tensor) else Tensor(unwrap(x))

    def f(a):
        shape = list(a.shape)
        if axis is not None:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            shape = [s if i in [ax % a.ndim for ax in axes] else 1
                     for i, s in enumerate(a.shape)]
        keep = _keep_mask(a, p, shape)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), 0.0)
        return torch.where(keep, a, 0.0)
    return apply_op("dropout", f, x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def _alpha_dropout_impl(x, p, name, mask_shape_of):
    """Shared SELU-preserving dropout: mask_shape_of(a) -> keep mask shape
    (full shape = element dropout; [N, C, 1, ...] = feature dropout)."""
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale

    def f(a):
        keep = _keep_mask(a, p, mask_shape_of(a))
        A = (1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2)))
        B = -A * p * alpha_p
        return A * torch.where(keep, a, alpha_p) + B
    return apply_op(name, f, x)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return _alpha_dropout_impl(x, p, "alpha_dropout", lambda a: a.shape)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of ENTIRE channels (dim 1): the SELU-preserving transform
    applied with a per-(sample, channel) keep mask (reference/torch
    FeatureAlphaDropout semantics)."""
    if not training or p == 0.0:
        return x
    return _alpha_dropout_impl(
        x, p, "feature_alpha_dropout",
        lambda a: tuple(a.shape[:2]) + (1,) * (a.ndim - 2))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    idx = unwrap(x)
    if sparse and torch.is_grad_enabled() and not weight.stop_gradient:
        raise NotImplementedError(
            "embedding(sparse=True) makes a row-sparse SelectedRows gradient, "
            "which the port does not have yet (M13); pass sparse=False")

    def f(w):
        if sharding.is_sharded(w):
            # a table sharded by rows (vocab-parallel): masked local lookups
            from ...parallel.mp_layers import vocab_parallel_lookup
            out = vocab_parallel_lookup(idx, w)
        else:
            out = TF.embedding(idx, w)
        if padding_idx is not None:
            out = torch.where((idx == padding_idx)[..., None], 0.0, out)
        return out
    return apply_op("embedding", f, weight)


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an index outside [0, num_classes) gives a row
    of zeros, as ``jax.nn.one_hot`` does."""
    idx = unwrap(x)
    classes = torch.arange(num_classes, device=idx.device)
    return _wrap((idx[..., None] == classes).to(torch.float32))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0, data_format=data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    def f(a, b):
        num = torch.sum(a * b, dim=axis)
        d1 = torch.sqrt(torch.sum(a * a, dim=axis))
        d2 = torch.sqrt(torch.sum(b * b, dim=axis))
        return num / torch.clamp(d1 * d2, min=eps)
    return apply_op("cosine_similarity", f, x1, x2)


def bilinear(x1, x2, weight, bias=None, name=None):
    def f(a, b, w, *bb):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        if bb:
            out = out + bb[0]
        return out
    args = (x1, x2, weight) + ((bias,) if bias is not None else ())
    return apply_op("bilinear", f, *args)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    pd = unwrap(prior_dist) if prior_dist is not None else None

    def f(lab):
        k = lab.shape[-1]
        uniform = pd if pd is not None else 1.0 / k
        return (1 - epsilon) * lab + epsilon * uniform
    return apply_op("label_smooth", f, label)


# ---- interpolate: jax.image.resize's weights ---------------------------------
def _linear_kernel(x):
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, device):
    """[n_in, n_out] float32 weights of one axis (``jax.image``'s
    ``compute_weight_mat`` with scale n_out / n_in, no translation,
    antialiasing on)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel(torch.abs(sample_f[None, :] - src[:, None]) / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_axis(a, ax, n_out, kernel):
    w = _resize_weights(a.shape[ax], n_out, kernel, a.device)
    moved = torch.movedim(a, ax, -1)
    out = torch.matmul(moved.to(torch.float32), w).to(a.dtype)
    return torch.movedim(out, -1, ax)


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW", name=None):
    mode = mode.lower()

    def f(a):
        chan_last = data_format in ("NHWC", "NDHWC", "NWC")
        spatial_idx = list(range(1, a.ndim - 1)) if chan_last else list(range(2, a.ndim))
        in_spatial = [a.shape[i] for i in spatial_idx]
        if size is not None:
            out_spatial = [int(unwrap(s)) for s in (size if isinstance(size, (list, tuple))
                                                    else np.asarray(unwrap(size)).tolist())]
        else:
            sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor] * len(in_spatial)
            out_spatial = [int(s * float(fs)) for s, fs in zip(in_spatial, sf)]
        kind = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
                "linear": "linear", "bicubic": "cubic", "area": "linear"}[mode]
        out = a
        for ax, n_in, n_out in zip(spatial_idx, in_spatial, out_spatial):
            if kind == "nearest":
                src = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                                device=a.device) + 0.5)
                                  * (n_in / n_out)).long()
                out = torch.index_select(out, ax, src)
            elif align_corners and kind == "linear":
                # explicit gather at align_corners source positions
                idx = (torch.zeros(1, dtype=torch.float32, device=a.device)
                       if n_out == 1 else
                       torch.linspace(0.0, n_in - 1, n_out, device=a.device))
                lo = torch.floor(idx).long()
                hi = torch.clamp(lo + 1, max=n_in - 1)
                shape = [1] * out.ndim
                shape[ax] = n_out
                w = (idx - lo).to(a.dtype).reshape(shape)
                out = (torch.index_select(out, ax, lo) * (1 - w)
                       + torch.index_select(out, ax, hi) * w)
            else:
                out = _resize_axis(out, ax, n_out, _linear_kernel
                                   if kind == "linear" else _keys_cubic_kernel)
        return out
    return apply_op("interpolate", f, x)


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def _pads(paddings):
    pd = _pair(paddings)
    return [pd[0], pd[1], pd[0], pd[1]] if len(pd) == 2 else pd


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (reference: phi/kernels/funcs/im2col) — NCHW input -> [N, C*kh*kw, L]."""
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _pads(paddings)

    def f(a):
        n, c, h, w = a.shape
        a = TF.pad(a, (pd[1], pd[3], pd[0], pd[2]))
        oh = (a.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
        ow = (a.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
        patches = []
        for i in range(ks[0]):
            for j in range(ks[1]):
                sl = a[:, :, i * dl[0]: i * dl[0] + oh * st[0]: st[0],
                       j * dl[1]: j * dl[1] + ow * st[1]: st[1]]
                patches.append(sl)
        out = torch.stack(patches, dim=2)  # [N, C, kh*kw, oh, ow]
        return out.reshape(n, c * ks[0] * ks[1], oh * ow)
    return apply_op("unfold", f, x)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    os_, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, dl = _pair(strides), _pair(dilations)
    pd = _pads(paddings)

    def f(a):
        n = a.shape[0]
        c = a.shape[1] // (ks[0] * ks[1])
        ph, pw = os_[0] + pd[0] + pd[2], os_[1] + pd[1] + pd[3]
        oh = (ph - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
        ow = (pw - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
        a2 = a.reshape(n, c, ks[0], ks[1], oh, ow)
        out = torch.zeros((n, c, ph, pw), dtype=a.dtype, device=a.device)
        for i in range(ks[0]):
            for j in range(ks[1]):
                sl = (slice(None), slice(None),
                      slice(i * dl[0], i * dl[0] + oh * st[0], st[0]),
                      slice(j * dl[1], j * dl[1] + ow * st[1], st[1]))
                out[sl] += a2[:, :, i, j]
        return out[:, :, pd[0]: ph - pd[2], pd[1]: pw - pd[3]]
    return apply_op("fold", f, x)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, c // (r * r), r, r, h, w)
            out = out.permute(0, 1, 4, 2, 5, 3)
            return out.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        out = a.reshape(n, h, w, r, r, c // (r * r))
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h * r, w * r, c // (r * r))
    return apply_op("pixel_shuffle", f, x)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, c, h // r, r, w // r, r)
            out = out.permute(0, 1, 3, 5, 2, 4)
            return out.reshape(n, c * r * r, h // r, w // r)
        n, h, w, c = a.shape
        out = a.reshape(n, h // r, r, w // r, r, c)
        return out.permute(0, 2, 4, 1, 3, 5).reshape(n, h // r, w // r, c * r * r)
    return apply_op("pixel_unshuffle", f, x)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            return a.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)
        n, h, w, c = a.shape
        return a.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(n, h, w, c)
    return apply_op("channel_shuffle", f, x)


__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "feature_alpha_dropout", "embedding", "one_hot", "pad",
           "zeropad2d", "cosine_similarity", "bilinear", "label_smooth",
           "interpolate", "upsample", "unfold", "fold", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle"]
