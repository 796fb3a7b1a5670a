"""Loss functionals: counterpart of ``paddle_tpu/nn/functional/loss.py``
(reference: python/paddle/nn/functional/loss.py).

Each is one ``apply_op`` dispatch of torch ops with the reference's
formulas, reductions and clamps.  ``cross_entropy`` computes its
log-softmax in float32 (the reference's softmax_with_cross_entropy kernel
contract), with hard or soft labels, ``weight=``, ``reduction=``,
``axis=`` and label smoothing; given ``torch.Tensor``s (the ``torch.nn``
models' loss) it runs the same body on them directly.
"""
from __future__ import annotations

import torch

from ...core.dispatch import apply_op, unwrap
from ...core.tensor import Tensor

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "sigmoid_focal_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _softplus(z):
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))


def _cross_entropy(logits, lbl, w, ignore_index, reduction, soft_label, axis,
                   use_softmax, label_smoothing):
    lg = logits.to(torch.float32)
    logp = torch.log_softmax(lg, dim=axis) if use_softmax else \
        torch.log(torch.clamp(lg, min=1e-30))
    n_cls = logits.shape[axis]
    if soft_label:
        soft = lbl.to(torch.float32)
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_cls
        loss = -torch.sum(soft * logp, dim=axis)
        return _reduce(loss, reduction)
    li = lbl
    if li.ndim == logp.ndim:
        li = torch.squeeze(li, dim=axis)
    mask = li != ignore_index
    li_ = torch.where(mask, li, 0).long()
    picked = torch.gather(logp, axis, torch.unsqueeze(li_, axis))
    picked = torch.squeeze(picked, dim=axis)
    if label_smoothing > 0.0:
        smooth = torch.mean(logp, dim=axis)
        loss = -((1 - label_smoothing) * picked + label_smoothing * smooth)
    else:
        loss = -picked
    loss = torch.where(mask, loss, 0.0)
    if w is not None:
        wv = w.to(torch.float32)[li_]
        loss = loss * wv
    if reduction == "mean":
        denom = mask.to(torch.float32) if w is None else torch.where(mask, wv, 0.0)
        return torch.sum(loss) / torch.clamp(torch.sum(denom), min=1e-12)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    lbl = unwrap(label)
    w = unwrap(weight) if weight is not None else None
    kw = dict(ignore_index=ignore_index, reduction=reduction,
              soft_label=soft_label, axis=axis, use_softmax=use_softmax,
              label_smoothing=label_smoothing)
    if not isinstance(input, Tensor):
        return _cross_entropy(input, lbl, w, **kw)
    return apply_op("cross_entropy",
                    lambda logits: _cross_entropy(logits, lbl, w, **kw), input)


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                         reduction="none", axis=axis)
    from .activation import softmax as _softmax
    loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, _softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    return _nll(input, label, weight, ignore_index, reduction)


def _nll(input, label, weight, ignore_index, reduction):
    lbl = unwrap(label)
    w = unwrap(weight) if weight is not None else None

    def f(logp):
        lg = logp.to(torch.float32)
        li = torch.where(lbl == ignore_index, 0, lbl).long()
        ax = -1 if lg.ndim == li.ndim + 1 else 1
        picked = torch.squeeze(torch.gather(lg, ax, torch.unsqueeze(li, ax)),
                               dim=ax)
        loss = -picked
        mask = lbl != ignore_index
        loss = torch.where(mask, loss, 0.0)
        if w is not None:
            wv = w.to(torch.float32)[li]
            loss = loss * wv
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp(
                    torch.sum(torch.where(mask, wv, 0.0)), min=1e-12)
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(
                torch.sum(mask.to(torch.float32)), min=1e-12)
        return _reduce(loss, reduction)
    return apply_op("nll_loss", f, input)


def mse_loss(input, label, reduction="mean", name=None):
    return apply_op("mse_loss", lambda a, b: _reduce(torch.square(a - b), reduction),
                    input, label)


def l1_loss(input, label, reduction="mean", name=None):
    return apply_op("l1_loss", lambda a, b: _reduce(torch.abs(a - b), reduction),
                    input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(loss, reduction)
    return apply_op("smooth_l1_loss", f, input, label)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    def f(p, t, *w):
        pf = torch.clamp(p.to(torch.float32), 1e-12, 1 - 1e-7)
        loss = -(t * torch.log(pf) + (1 - t) * torch.log1p(-pf))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = (input, label) + ((weight,) if weight is not None else ())
    return apply_op("binary_cross_entropy", f, *args)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    pw = unwrap(pos_weight) if pos_weight is not None else None

    def f(z, t, *w):
        zf = z.to(torch.float32)
        tf_ = t.to(torch.float32)
        if pw is not None:
            logw = 1.0 + (pw - 1.0) * tf_
            loss = (1 - tf_) * zf + logw * (_softplus(-torch.abs(zf))
                                            + torch.clamp(-zf, min=0.0))
        else:
            loss = torch.clamp(zf, min=0) - zf * tf_ + _softplus(-torch.abs(zf))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = (logit, label) + ((weight,) if weight is not None else ())
    return apply_op("bce_with_logits", f, *args)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def f(logp, t):
        tf_ = t.to(torch.float32)
        lp = logp.to(torch.float32)
        if log_target:
            loss = torch.exp(tf_) * (tf_ - lp)
        else:
            loss = torch.where(tf_ > 0, tf_ * (torch.log(torch.clamp(tf_, min=1e-30))
                                               - lp), 0.0)
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)
    return apply_op("kl_div", f, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    def f(a, b, t):
        loss = torch.clamp(-t * (a - b) + margin, min=0.0)
        return _reduce(loss, reduction)
    return apply_op("margin_ranking_loss", f, input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):
    def f(a, t):
        loss = torch.where(t == 1, a, torch.clamp(margin - a, min=0.0))
        return _reduce(loss, reduction)
    return apply_op("hinge_embedding_loss", f, input, label)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean", name=None):
    def f(a, b, t):
        cos = torch.sum(a * b, -1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        loss = torch.where(t == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
        return _reduce(loss, reduction)
    return apply_op("cosine_embedding_loss", f, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-6,
                        swap=False, reduction="mean", name=None):
    def dist(u, v):
        return torch.pow(torch.sum(torch.pow(torch.abs(u - v) + epsilon, p), -1),
                         1 / p)

    def f(a, pos, neg):
        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)
    return apply_op("triplet_margin_loss", f, input, positive, negative)


def square_error_cost(input, label):
    return apply_op("square_error_cost", lambda a, b: torch.square(a - b), input, label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    nz = unwrap(normalizer) if normalizer is not None else None

    def f(z, t):
        zf, tf_ = z.to(torch.float32), t.to(torch.float32)
        p = torch.sigmoid(zf)
        ce = torch.clamp(zf, min=0) - zf * tf_ + _softplus(-torch.abs(zf))
        p_t = p * tf_ + (1 - p) * (1 - tf_)
        a_t = alpha * tf_ + (1 - alpha) * (1 - tf_)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if nz is not None:
            loss = loss / nz
        return _reduce(loss, reduction)
    return apply_op("sigmoid_focal_loss", f, logit, label)
