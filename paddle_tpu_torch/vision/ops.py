"""paddle.vision.ops: counterpart of ``paddle_tpu/vision/ops.py`` (reference:
python/paddle/vision/ops.py — nms:1934, roi_align:1705, roi_pool:1610).

Torch ops only (no ``torchvision``):

- ``nms`` sorts once, builds the strictly upper-triangular suppression
  matrix of the sorted boxes, and walks it in order on the device: step
  ``i`` clears the later boxes that box ``i`` suppresses if ``i`` is still
  alive, two launches a step and no read back to the host inside the
  loop.  A box's fate is settled when the walk reaches it, so the alive
  mask at the end is the keep mask.
- ``roi_align`` uses the separability of bilinear sampling: a bin's value
  is ``Wy @ feat @ Wx^T`` with ``Wy`` [ph, H] (``Wx`` [pw, W]) the mean of
  the samples' row (column) weights, so it never gathers
  [R, C, ph * r, pw * r] corners.  The rois of one image are contiguous
  (``boxes_num``), so each image is two matmuls.
- ``roi_pool`` takes the max over each bin's integer cells (the
  reference's membership rule, empty bins 0) without the reference's
  [R, C, ph, pw, H, W] mask: a sparse table over W answers each roi's
  column ranges from two lookups, then each row bin is a masked max over
  H of [R, pw, C, H].
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap

__all__ = ["nms", "roi_align", "roi_pool", "box_area", "box_iou"]


def box_area(boxes):
    def f(b):
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return apply_op("box_area", f, boxes)


def _iou_matrix(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter,
                               min=1e-10)


def box_iou(boxes1, boxes2):
    return apply_op("box_iou", _iou_matrix, boxes1, boxes2)


def _as_tensor(x, like):
    if isinstance(x, Tensor):
        return x
    return Tensor(torch.as_tensor(np.asarray(x), device=unwrap(like).device))


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """reference: vision/ops.py nms:1934 — returns kept indices sorted by
    score (ties in their input order: the sort is stable)."""
    boxes = boxes if isinstance(boxes, Tensor) else Tensor(np.asarray(boxes))
    b = unwrap(boxes)
    n = b.shape[0]
    s = _as_tensor(scores, boxes) if scores is not None else Tensor(
        torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))

    def f(bx, sc, *cat):
        order = torch.argsort(-sc, stable=True)
        bs = bx[order]
        iou = _iou_matrix(bs, bs)
        if cat:  # category-aware: only same-category boxes suppress
            cs = cat[0][order]
            iou = torch.where(cs[:, None] == cs[None, :], iou, 0.0)
        # sup[i, j]: box i suppresses box j (a later one) if i is kept
        sup = torch.triu(iou > iou_threshold, diagonal=1).to(torch.float32)
        alive = torch.ones(n, dtype=torch.float32, device=bx.device)
        one = torch.ones((), dtype=torch.float32, device=bx.device)
        for i in range(n):
            alive.mul_(torch.addcmul(one, sup[i], alive[i], value=-1.0))
        return order[alive.bool()]

    args = (boxes, s)
    if category_idxs is not None:
        args += (_as_tensor(category_idxs, boxes),)
    with torch.no_grad():
        out = apply_op("nms", f, *args)
    if top_k is not None:
        out = out[:top_k]
    return out


def _rois_per_image(boxes_num, n_rois):
    """The (start, end) roi slice of each image: rois are laid out image by
    image, ``boxes_num[i]`` of them for image i (one host read of the
    counts, as the reference's CUDA kernel copies them to the host)."""
    counts = np.asarray(unwrap(boxes_num).tolist() if isinstance(
        boxes_num, Tensor) else boxes_num, np.int64).reshape(-1)
    ends = np.cumsum(counts)
    if ends[-1] != n_rois:
        raise ValueError(f"boxes_num sums to {int(ends[-1])}, but there are "
                         f"{n_rois} rois")
    return [(int(e - c), int(e)) for c, e in zip(counts, ends)]


def _sample_weights(lo, size, bins, ratio, n):
    """[R, bins, n] weights of one axis: for each bin, the mean over its
    ``ratio`` samples of their bilinear weights on the ``n`` cells, the
    coordinates clamped into the image first (the reference's
    ``_bilinear``: clamped, never extrapolated)."""
    dev = lo.device
    bin_sz = size / bins                                         # [R]
    k = torch.arange(bins, device=dev, dtype=lo.dtype)
    s = (torch.arange(ratio, device=dev, dtype=lo.dtype) + 0.5) / ratio
    c = (k[None, :, None] * bin_sz[:, None, None] + lo[:, None, None]
         + s[None, None, :] * bin_sz[:, None, None])           # [R, b, r]
    c = torch.clamp(c, 0.0, n - 1.0)
    c0 = torch.clamp(torch.floor(c), 0, n - 1)
    c1 = torch.clamp(c0 + 1, 0, n - 1)
    lc = c - c0
    cells = torch.arange(n, device=dev, dtype=lo.dtype)
    w = ((1 - lc)[..., None] * (cells == c0[..., None])
         + lc[..., None] * (cells == c1[..., None]))            # [R, b, r, n]
    return w.mean(dim=2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """reference: vision/ops.py roi_align:1705. x [N, C, H, W]; boxes
    [R, 4] in (x1, y1, x2, y2); boxes_num [N] rois per image."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    ratio = 2 if sampling_ratio <= 0 else sampling_ratio
    spans = _rois_per_image(boxes_num, unwrap(boxes).shape[0])

    def f(xa, ba):
        H, W = xa.shape[-2:]
        off = 0.5 if aligned else 0.0
        sb = ba * spatial_scale - off
        x1, y1, x2, y2 = sb.unbind(1)
        rw = torch.clamp(x2 - x1, min=1e-3)
        rh = torch.clamp(y2 - y1, min=1e-3)
        wy = _sample_weights(y1, rh, ph, ratio, H).to(xa.dtype)  # [R, ph, H]
        wx = _sample_weights(x1, rw, pw, ratio, W).to(xa.dtype)  # [R, pw, W]
        outs = []
        for img, (s, e) in enumerate(spans):
            if e == s:
                continue
            # [C, H, W] @ Wx^T -> [C, H, r * pw], then Wy @ per roi
            t = torch.matmul(xa[img], wx[s:e].reshape(-1, W).t())
            t = t.reshape(xa.shape[1], H, e - s, pw).permute(2, 0, 1, 3)
            outs.append(torch.matmul(wy[s:e, None], t))       # [r, C, ph, pw]
        return torch.cat(outs) if outs else xa.new_zeros(
            (0, xa.shape[1], ph, pw))

    return apply_op("roi_align", f, x, boxes)


def _bin_ranges(lo, hi, size, bins, n):
    """[R, bins] start and end (exclusive) cells of each bin under the
    reference's rule: cell c is in bin floor((c - lo) / (size / bins)) when
    lo <= c <= hi; a bin with no cell has start >= end."""
    dev = lo.device
    cells = torch.arange(n, dtype=torch.float32, device=dev)
    bin_of = torch.floor((cells[None, :] - lo[:, None])
                         / (size / bins)[:, None])             # [R, n]
    inside = (cells[None, :] >= lo[:, None]) & (cells[None, :] <= hi[:, None])
    k = torch.arange(bins, device=dev, dtype=torch.float32)
    member = inside[:, None, :] & (bin_of[:, None, :] == k[None, :, None])
    idx = torch.arange(n, device=dev)
    start = torch.where(member, idx, n).amin(-1)
    end = torch.where(member, idx + 1, 0).amax(-1)
    return start, end


def _sparse_table(a):
    """[K, ..., W]: level k holds max(a[..., w : w + 2^k]) (-inf past the
    end), K = floor(log2 W) + 1."""
    levels = [a]
    span = 1
    while 2 * span <= a.shape[-1]:
        prev = levels[-1]
        nxt = torch.full_like(prev, -float("inf"))
        nxt[..., :-span] = torch.maximum(prev[..., :-span], prev[..., span:])
        levels.append(nxt)
        span *= 2
    return torch.stack(levels)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """reference: vision/ops.py roi_pool:1610 — max pooling per bin."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    spans = _rois_per_image(boxes_num, unwrap(boxes).shape[0])

    def f(xa, ba):
        N, C, H, W = xa.shape
        dev = xa.device
        img = torch.cat([torch.full((e - s,), i, device=dev)
                         for i, (s, e) in enumerate(spans)])
        sb = torch.round(ba * spatial_scale)
        x1, y1, x2, y2 = sb.unbind(1)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        cs, ce = _bin_ranges(x1, x2, rw, pw, W)                # [R, pw]
        rs, re = _bin_ranges(y1, y2, rh, ph, H)                # [R, ph]
        # the max of each roi's column bins: two overlapping sparse-table
        # lookups cover [cs, ce)
        table = _sparse_table(xa).permute(0, 1, 4, 2, 3)       # [K,N,W,C,H]
        length = torch.clamp(ce - cs, min=1)
        k = torch.floor(torch.log2(length.to(torch.float32))).long()
        a = torch.clamp(cs, max=W - 1)
        b = torch.clamp(ce - 2 ** k, min=0)
        cols = torch.maximum(table[k, img[:, None], a],
                             table[k, img[:, None], b])        # [R,pw,C,H]
        cols = torch.where((ce > cs)[:, :, None, None], cols, -float("inf"))
        hs = torch.arange(H, device=dev)
        rows = []
        for i in range(ph):
            m = (hs[None, :] >= rs[:, i:i + 1]) & (hs[None, :] < re[:, i:i + 1])
            rows.append(torch.where(m[:, None, None, :], cols,
                                    -float("inf")).amax(-1))   # [R, pw, C]
        out = torch.stack(rows, 1).permute(0, 3, 1, 2)         # [R,C,ph,pw]
        return torch.where(torch.isfinite(out), out, 0.0)     # empty bins

    return apply_op("roi_pool", f, x, boxes)
