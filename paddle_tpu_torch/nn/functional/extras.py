"""Functional-surface completion, part 2: counterpart of
``paddle_tpu/nn/functional/extras.py`` (reference: python/paddle/nn/functional/
— pooling variants, vision sampling, seq2seq helpers, attention wrappers,
inplace activation forms).

Each op is one ``apply_op`` of torch math with the reference's formulas
(not torch's library forms, whose edge conventions differ).  Random draws
(fractional pooling's offset, ``class_center_sample``'s negatives) come
from the port's generator, so they do not match the reference's keys.
``flash_attn_qkvpacked`` reaches the flash kernels (K1-K3 on the card)
through ``flash_attention``; ``flashmask_attention`` takes the masked
dense path, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import apply_op, unwrap
from ...core.tensor import Tensor
from . import activation as _act
from .pooling import avg_pool1d, avg_pool2d


# ---- inplace activation forms (reference: elu_/tanh_/... in activation.py) --
def _inplace(fn):
    def f(x, *a, **k):
        out = fn(x, *a, **k)
        x._data = out._data
        return x
    return f


elu_ = _inplace(_act.elu)
hardtanh_ = _inplace(_act.hardtanh)
leaky_relu_ = _inplace(_act.leaky_relu)
tanh_ = _inplace(_act.tanh)
thresholded_relu_ = _inplace(_act.thresholded_relu)


# ---- distance ----------------------------------------------------------------
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """reference distance.py pairwise_distance (the PairwiseDistance layer's
    functional form)."""
    def f(a, b):
        d = (a - b).float() + epsilon
        out = torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)
        return out[..., None] if keepdim else out
    return apply_op("pairwise_distance", f, x, y)


# ---- LP / fractional pooling -------------------------------------------------
def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """reference pooling.py lp_pool1d: (avg(|x|^p) * k)^(1/p)."""
    p = float(norm_type)
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    powed = apply_op("lp_pow", lambda a: torch.abs(a.float()) ** p, x)
    pooled = avg_pool1d(powed, kernel_size, stride, padding,
                        ceil_mode=ceil_mode, data_format=data_format,
                        exclusive=False)
    return apply_op("lp_root", lambda a: (a * float(k)) ** (1.0 / p), pooled)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    p = float(norm_type)
    ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    powed = apply_op("lp_pow", lambda a: torch.abs(a.float()) ** p, x)
    pooled = avg_pool2d(powed, kernel_size, stride, padding,
                        ceil_mode=ceil_mode, data_format=data_format,
                        exclusive=False)
    n = float(np.prod(ks))
    return apply_op("lp_root", lambda a: (a * n) ** (1.0 / p), pooled)


def _fractional_bounds(in_size, out_size, u):
    """Pseudo-random fractional pooling boundaries (torch-style: alpha =
    in/out; start_i = ceil(alpha*(i+u)) - ceil(alpha*u))."""
    alpha = in_size / out_size
    i = np.arange(out_size + 1)
    pts = np.ceil(alpha * (i + u)).astype(np.int64) - int(np.ceil(alpha * u))
    pts = np.clip(pts, 0, in_size)
    pts[-1] = in_size
    return pts


def _frac_window(bounds, i, k, limit):
    """[start, end) of fractional window i: pseudo-random partition cell, or
    an overlapping k-sized window at the cell's start when kernel_size set."""
    lo = bounds[i]
    hi = bounds[i + 1] if k is None else min(lo + k, limit)
    return lo, max(hi, lo + 1)


def _random_u(x):
    """The fractional offset u in [0.05, 0.95), drawn from the port's
    generator on x's device."""
    from ...core.rng import next_generator
    dev = unwrap(x).device
    u = torch.rand((), generator=next_generator(dev), device=dev)
    return float(u * 0.9 + 0.05)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """reference pooling.py fractional_max_pool2d (NCHW)."""
    N, C, H, W = x.shape
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    u = _random_u(x) if random_u is None else float(random_u)
    hb = _fractional_bounds(H, oh, u)
    wb = _fractional_bounds(W, ow, u)
    ks = None if kernel_size is None else (
        (kernel_size, kernel_size) if isinstance(kernel_size, int)
        else tuple(kernel_size))
    kh, kw = (None, None) if ks is None else ks

    def f(a):
        rows = []
        for i in range(oh):
            cols = []
            for j in range(ow):
                h0, h1 = _frac_window(hb, i, kh, H)
                w0, w1 = _frac_window(wb, j, kw, W)
                cols.append(torch.amax(a[:, :, h0:h1, w0:w1], dim=(2, 3)))
            rows.append(torch.stack(cols, dim=-1))
        return torch.stack(rows, dim=-2)     # [N, C, oh, ow]
    out = apply_op("fractional_max_pool2d", f, x)
    if return_mask:
        # indices of the max inside each fractional window (flat H*W)
        a_np = x.numpy()
        m = np.zeros((N, C, oh, ow), np.int32)
        for i in range(oh):
            for j in range(ow):
                h0, h1 = _frac_window(hb, i, kh, H)
                w0, w1 = _frac_window(wb, j, kw, W)
                win = a_np[:, :, h0:h1, w0:w1]
                k = np.argmax(win.reshape(N, C, -1), axis=-1)
                ww = win.shape[3]
                m[:, :, i, j] = ((h0 + k // ww) * W + (w0 + k % ww))
        return out, Tensor(torch.as_tensor(m, device=unwrap(x).device))
    return out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """reference pooling.py fractional_max_pool3d (NCDHW)."""
    if return_mask:
        raise NotImplementedError("fractional_max_pool3d return_mask")
    N, C, D, H, W = x.shape
    od, oh, ow = (output_size,) * 3 if isinstance(output_size, int) \
        else tuple(output_size)
    u = _random_u(x) if random_u is None else float(random_u)
    db = _fractional_bounds(D, od, u)
    hb = _fractional_bounds(H, oh, u)
    wb = _fractional_bounds(W, ow, u)

    ks = None if kernel_size is None else (
        (kernel_size,) * 3 if isinstance(kernel_size, int)
        else tuple(kernel_size))

    def f(a):
        planes = []
        for d in range(od):
            rows = []
            for i in range(oh):
                cols = []
                for j in range(ow):
                    d0, d1 = _frac_window(db, d, None if ks is None else ks[0], D)
                    h0, h1 = _frac_window(hb, i, None if ks is None else ks[1], H)
                    w0, w1 = _frac_window(wb, j, None if ks is None else ks[2], W)
                    cols.append(torch.amax(a[:, :, d0:d1, h0:h1, w0:w1],
                                           dim=(2, 3, 4)))
                rows.append(torch.stack(cols, dim=-1))
            planes.append(torch.stack(rows, dim=-2))
        return torch.stack(planes, dim=-3)   # [N, C, od, oh, ow]
    return apply_op("fractional_max_pool3d", f, x)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    """Inverse of a max_pool3d-with-indices (flat D*H*W positions)."""
    if data_format != "NCDHW":
        raise ValueError("max_unpool3d supports NCDHW only")
    ks = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(kernel_size)
    st = ks if stride is None else ((stride,) * 3 if isinstance(stride, int)
                                    else tuple(stride))
    pd = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    if output_size is None:
        sp = x.shape[2:]
        output_size = tuple((sp[i] - 1) * st[i] - 2 * pd[i] + ks[i]
                            for i in range(3))
    Do, Ho, Wo = tuple(output_size)[-3:]

    def f(a, idx):
        N, C = a.shape[:2]
        flat = torch.zeros((N, C, Do * Ho * Wo), dtype=a.dtype,
                           device=a.device)
        out = flat.scatter(2, idx.reshape(N, C, -1).long(),
                           a.reshape(N, C, -1))
        return out.reshape(N, C, Do, Ho, Wo)
    return apply_op("max_unpool3d", f, x, indices)


# ---- vision sampling ---------------------------------------------------------
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """reference vision.py affine_grid: theta [N, 2, 3] -> grid [N, H, W, 2]
    (the 5-element NCDHW/theta [N, 3, 4] volumetric form is not implemented)."""
    if len(out_shape) == 5:
        raise NotImplementedError("3-D affine_grid (NCDHW out_shape)")
    N, _, H, W = (out_shape if len(out_shape) == 4 else
                  (out_shape[0], 1, out_shape[1], out_shape[2]))

    def f(th):
        t32 = th.float()
        dev = th.device
        if align_corners:
            xs = torch.linspace(-1.0, 1.0, W, device=dev)
            ys = torch.linspace(-1.0, 1.0, H, device=dev)
        else:
            xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1
            ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1
        gy, gx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
        ones = torch.ones_like(gx)
        base = torch.stack([gx, gy, ones], dim=-1)        # [H, W, 3]
        return torch.einsum("hwk,njk->nhwj", base, t32)   # [N, H, W, 2]
    return apply_op("affine_grid", f, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """reference vision.py grid_sample (NCHW + grid [N, Ho, Wo, 2] in
    [-1, 1] xy order). Bilinear/nearest; zeros/border/reflection padding."""
    def f(a, g):
        a32 = a.float()
        N, C, H, W = a32.shape
        gx, gy = g[..., 0].float(), g[..., 1].float()
        if align_corners:
            fx = (gx + 1) * (W - 1) / 2
            fy = (gy + 1) * (H - 1) / 2
        else:
            fx = ((gx + 1) * W - 1) / 2
            fy = ((gy + 1) * H - 1) / 2

        def reflect(v, lo, hi):
            rng = hi - lo
            if rng <= 0:
                return v
            t = torch.remainder(v - lo, 2 * rng)
            return lo + (rng - torch.abs(t - rng))   # triangle-wave fold
        if padding_mode == "reflection":
            if align_corners:
                fx = reflect(fx, 0.0, W - 1.0)
                fy = reflect(fy, 0.0, H - 1.0)
            else:
                # torch convention: reflect about pixel EDGES, then clip
                fx = torch.clip(reflect(fx, -0.5, W - 0.5), 0, W - 1)
                fy = torch.clip(reflect(fy, -0.5, H - 0.5), 0, H - 1)
        n_idx = torch.arange(N, device=a.device)[:, None, None]

        def sample(ix, iy):
            okx = (ix >= 0) & (ix <= W - 1)
            oky = (iy >= 0) & (iy <= H - 1)
            cx = torch.clip(ix, 0, W - 1).long()
            cy = torch.clip(iy, 0, H - 1).long()
            v = a32[n_idx, :, cy, cx]                     # [N, Ho, Wo, C]
            if padding_mode == "zeros":
                v = v * (okx & oky)[..., None]
            return v

        if mode == "nearest":
            out = sample(torch.round(fx), torch.round(fy))
        else:
            x0, y0 = torch.floor(fx), torch.floor(fy)
            x1, y1 = x0 + 1, y0 + 1
            wa = (x1 - fx) * (y1 - fy)
            wb = (fx - x0) * (y1 - fy)
            wc = (x1 - fx) * (fy - y0)
            wd = (fx - x0) * (fy - y0)
            out = (sample(x0, y0) * wa[..., None] + sample(x1, y0) * wb[..., None]
                   + sample(x0, y1) * wc[..., None] + sample(x1, y1) * wd[..., None])
        return torch.movedim(out, -1, 1).to(a.dtype)   # [N, C, Ho, Wo]
    return apply_op("grid_sample", f, x, grid)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW", name=None):
    """reference extension.py temporal_shift (TSM): shift 1/r channels one
    frame back, 1/r forward within each segment."""
    if data_format != "NCHW":
        raise ValueError("temporal_shift supports NCHW")

    def f(a):
        NT, C, H, W = a.shape
        N = NT // seg_num
        v = a.reshape(N, seg_num, C, H, W)
        c1 = int(C * shift_ratio)
        c2 = int(C * 2 * shift_ratio)
        back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
        fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]],
                        1)
        keep = v[:, :, c2:]
        return torch.cat([back, fwd, keep], dim=2).reshape(NT, C, H, W)
    return apply_op("temporal_shift", f, x)


def gather_tree(ids, parents, name=None):
    """reference extension.py gather_tree: backtrack beam-search parent
    pointers [T, B, beam] -> full sequences (a loop from the last step
    back, as the reference's reversed scan)."""
    def f(idv, par):
        T = idv.shape[0]
        beam = torch.arange(idv.shape[2], device=idv.device)[None, :]
        next_beam = beam.expand(idv.shape[1:]).to(idv.dtype)
        toks = []
        for t in range(T - 1, -1, -1):
            sel = next_beam.long()
            toks.append(torch.gather(idv[t], 1, sel))
            next_beam = torch.gather(par[t], 1, sel)
        return torch.stack(toks[::-1])
    return apply_op("gather_tree", f, ids, parents)


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """reference common.py class_center_sample: keep all positive classes +
    uniformly sampled negatives; remap labels into the sampled index space."""
    from ...core.rng import next_generator
    lbl = label.numpy().reshape(-1)
    pos = np.unique(lbl)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos)
        k = num_samples - len(pos)
        cpu = torch.device("cpu")
        pick = torch.randperm(len(neg_pool), generator=next_generator(cpu),
                              device=cpu)[:k].numpy()
        sampled = np.sort(np.concatenate([pos, neg_pool[pick]]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = unwrap(label).device
    # 32-bit, as the reference's (JAX runs with x64 off)
    return (Tensor(torch.as_tensor(remap[lbl].astype(np.int32), device=dev)),
            Tensor(torch.as_tensor(sampled.astype(np.int32), device=dev)))


# ---- attention wrappers ------------------------------------------------------
def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, name=None, **kw):
    """reference flash_attention.py flashmask_attention: flash attention with
    sparse row-bound masks, realized via the dense-mask SDPA path (the
    reference's route); the row-bound form maps to an explicit additive
    mask."""
    from .attention import scaled_dot_product_attention
    mask = None
    if startend_row_indices is not None:
        idx = unwrap(startend_row_indices)          # [B, H, S, 1] (causal LT)
        S = query.shape[1]
        rows = torch.arange(S, device=idx.device)
        start = idx.squeeze(-1)                     # [B, Hm, S]
        # token j is masked for query i when i >= start[j]
        m = rows[None, None, :, None] < start[:, :, None, :]
        mask = Tensor(torch.where(m, 0.0, float("-inf")).float())
    return scaled_dot_product_attention(query, key, value, attn_mask=mask,
                                        dropout_p=dropout, is_causal=causal)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         *a, **kw):
    """reference flash_attention.py flash_attn_qkvpacked: qkv [B, S, 3, H, D]."""
    from .attention import flash_attention
    q = qkv[:, :, 0]
    k = qkv[:, :, 1]
    v = qkv[:, :, 2]
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q=None, cu_seqlens_k=None,
                                *a, **kw):
    raise NotImplementedError(
        "varlen packed flash attention: pad to dense [B, S, 3, H, D] and use "
        "flash_attn_qkvpacked (ragged batching lands with the paged-attention "
        "serving path)")


def sparse_attention(*a, **kw):
    raise NotImplementedError(
        "block-sparse attention (the reference's sparse_attention op) is not "
        "ported; use flashmask_attention for masked patterns")
