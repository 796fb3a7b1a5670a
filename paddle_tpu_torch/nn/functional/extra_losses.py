"""Loss-surface completion: counterpart of
``paddle_tpu/nn/functional/extra_losses.py`` (reference: python/paddle/nn/
functional/loss.py — poisson_nll, multi-label / multi-margin / soft-margin
families, gaussian_nll, dice, log, npair, hsigmoid, margin_cross_entropy,
ctc, rnnt, adaptive log-softmax).

All math in f32 with the file-standard ``_reduce`` semantics from loss.py,
each loss one ``apply_op`` of the reference's formulas in torch.  ``ctc_loss``
and ``rnnt_loss`` run the reference's log-domain alpha recursions (a loop
over time, and over the label positions for RNN-T, where the reference
scans), so their values and reductions are the reference's: ``ctc_loss``'s
mean divides each loss by its label length, and ``rnnt_loss``'s FastEmit
scales the label-emission gradients only.
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op, unwrap
from ...core.tensor import Tensor
from .loss import _reduce

NEG = -1e30


def _one_hot(lbl, C):
    return TF.one_hot(lbl.long(), C).float()


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    """reference loss.py poisson_nll_loss."""
    def f(x, y):
        x32, y32 = x.float(), y.float()
        if log_input:
            out = torch.exp(x32) - y32 * x32
        else:
            out = x32 - y32 * torch.log(x32 + epsilon)
        if full:
            # Stirling approximation for y! applied where y > 1
            stir = y32 * torch.log(y32 + 1e-30) - y32 + 0.5 * torch.log(
                2 * _math.pi * torch.clamp_min(y32, 1e-30))
            out = out + torch.where(y32 > 1, stir, 0.0)
        return _reduce(out, reduction)
    return apply_op("poisson_nll_loss", f, input, label)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """reference loss.py gaussian_nll_loss."""
    def f(mu, y, var):
        v = torch.clamp_min(var.float(), epsilon)
        out = 0.5 * (torch.log(v) + (y.float() - mu.float()) ** 2 / v)
        if full:
            out = out + 0.5 * _math.log(2 * _math.pi)
        return _reduce(out, reduction)
    return apply_op("gaussian_nll_loss", f, input, label, variance)


def soft_margin_loss(input, label, reduction="mean", name=None):
    """reference loss.py soft_margin_loss: log(1 + exp(-y * x))."""
    def f(x, y):
        out = torch.log1p(torch.exp(-y.float() * x.float()))
        return _reduce(out, reduction)
    return apply_op("soft_margin_loss", f, input, label)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    """reference loss.py multi_label_soft_margin_loss."""
    args = (input, label) + ((weight,) if weight is not None else ())

    def f(x, y, *w):
        x32, y32 = x.float(), y.float()
        per = -(y32 * TF.logsigmoid(x32) + (1 - y32) * TF.logsigmoid(-x32))
        if w:
            per = per * w[0].float()
        out = per.mean(dim=-1)
        return _reduce(out, reduction)
    return apply_op("multi_label_soft_margin_loss", f, *args)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """reference loss.py multi_margin_loss (hinge over classes)."""
    lbl = unwrap(label)
    args = (input,) + ((weight,) if weight is not None else ())

    def f(x, *w):
        x32 = x.float()
        N, C = x32.shape
        correct = torch.gather(x32, 1, lbl[:, None].long())
        m = torch.clamp_min(margin - correct + x32, 0.0) ** p
        if w:
            m = m * w[0].float()[lbl.long()][:, None]
        onehot = _one_hot(lbl, C)
        out = torch.sum(m * (1 - onehot), dim=1) / C
        return _reduce(out, reduction)
    return apply_op("multi_margin_loss", f, *args)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean", name=None):
    """reference loss.py triplet_margin_with_distance_loss (custom metric)."""
    if distance_function is None:
        def distance_function(a, b):
            diff = a - b
            return (diff * diff).sum(-1).sqrt() if isinstance(diff, Tensor) \
                else torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_pn = distance_function(positive, negative)
        d_an = d_an.minimum(d_pn) if isinstance(d_an, Tensor) else \
            torch.minimum(d_an, d_pn)

    def f(ap, an):
        out = torch.clamp_min(ap.float() - an.float() + margin, 0.0)
        return _reduce(out, reduction)
    return apply_op("triplet_margin_with_distance_loss", f, d_ap, d_an)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """reference loss.py dice_loss: input [N, ..., C] probs, label [N, ..., 1]
    class ids."""
    lbl = unwrap(label)

    def f(x):
        x32 = x.float()
        C = x32.shape[-1]
        onehot = _one_hot(lbl.squeeze(-1), C)
        red = tuple(range(1, x32.ndim))
        inter = torch.sum(x32 * onehot, dim=red)
        union = torch.sum(x32, dim=red) + torch.sum(onehot, dim=red)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))
    return apply_op("dice_loss", f, input)


def log_loss(input, label, epsilon=1e-4, name=None):
    """reference loss.py log_loss (binary cross entropy on probabilities,
    elementwise, no reduction)."""
    def f(p, y):
        p32, y32 = p.float(), y.float()
        return -(y32 * torch.log(p32 + epsilon) +
                 (1 - y32) * torch.log(1 - p32 + epsilon))
    return apply_op("log_loss", f, input, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """reference loss.py npair_loss."""
    lbl = unwrap(labels)

    def f(a, p):
        a32, p32 = a.float(), p.float()
        reg = l2_reg * (torch.mean(torch.sum(a32 * a32, 1)) +
                        torch.mean(torch.sum(p32 * p32, 1))) * 0.25
        sim = a32 @ p32.T                       # [N, N]
        same = (lbl[:, None] == lbl[None, :]).float()
        tgt = same / torch.sum(same, dim=1, keepdim=True)
        logp = torch.log_softmax(sim, dim=1)
        xent = -torch.mean(torch.sum(tgt * logp, dim=1))
        return xent + reg
    return apply_op("npair_loss", f, anchor, positive)


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None,
                  path_code=None, is_sparse=False, name=None):
    """Hierarchical sigmoid over the default complete binary tree (reference
    loss.py hsigmoid_loss; phi hsigmoid_loss kernel). Without a custom
    path_table, class c's path is its binary-heap route: internal node ids
    are (c + num_classes) halved until the root, codes are the low bits."""
    lbl = label.numpy() if isinstance(label, Tensor) else np.asarray(label)
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    # per-sample paths on the host (labels are data, shapes static)
    if path_table is not None:
        table = np.asarray(path_table.numpy() if isinstance(
            path_table, Tensor) else path_table)
        codes = np.asarray(path_code.numpy() if isinstance(
            path_code, Tensor) else path_code).astype(np.float32)
        valid = (table >= 0).astype(np.float32)
        table = np.maximum(table, 0)
    else:
        table = np.zeros((len(lbl), depth), np.int64)
        codes = np.zeros((len(lbl), depth), np.float32)
        valid = np.zeros((len(lbl), depth), np.float32)
        for i, c in enumerate(lbl.reshape(-1)):
            node = int(c) + num_classes
            k = 0
            while node > 1:
                table[i, k] = node // 2 - 1     # internal node row in weight
                codes[i, k] = node % 2
                valid[i, k] = 1.0
                node //= 2
                k += 1
    args = (input, weight) + ((bias,) if bias is not None else ())

    def f(x, w, *b):
        dev = x.device
        tj = torch.as_tensor(table, device=dev).long()
        cj = torch.as_tensor(codes, device=dev)
        vj = torch.as_tensor(valid, device=dev)
        x32 = x.float()
        wsel = w.float()[tj]                     # [N, depth, D]
        logits = torch.einsum("nd,nkd->nk", x32, wsel)
        if b:
            logits = logits + b[0].float().reshape(-1)[tj]
        # code 1 -> sigmoid(logit), code 0 -> sigmoid(-logit)
        sign = 2 * cj - 1
        logp = TF.logsigmoid(sign * logits) * vj
        return -torch.sum(logp, dim=1, keepdim=True)
    return apply_op("hsigmoid_loss", f, *args)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, return_softmax=False,
                         reduction="mean", name=None):
    """ArcFace-family margin softmax (reference loss.py margin_cross_entropy:
    cos(m1*theta + m2) - m3 applied to the target logit)."""
    lbl = unwrap(label)

    def f(lg):
        # clip strictly inside (-1, 1): d/dx arccos explodes at the boundary
        x = torch.clip(lg.float(), -1.0 + 1e-6, 1.0 - 1e-6)
        N, C = x.shape
        idx = lbl[:, None].long()
        theta = torch.arccos(torch.gather(x, 1, idx))
        target = torch.cos(margin1 * theta + margin2) - margin3
        onehot = _one_hot(lbl, C)
        adj = x * (1 - onehot) + target * onehot
        adj = adj * scale
        logp = torch.log_softmax(adj, dim=1)
        loss = -torch.gather(logp, 1, idx)
        sm = torch.exp(logp)
        red = _reduce(loss, reduction)
        return (red, sm) if return_softmax else red
    out = apply_op("margin_cross_entropy", f, logits)
    return out


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC forward-algorithm loss (reference loss.py ctc_loss over the
    warpctc kernel). log_probs [T, B, C] raw logits (log-softmax applied
    here, matching the reference), labels [B, L] padded with anything.
    A loop over time; log-domain alpha recursion over the extended
    blank-interleaved label sequence."""
    lbl = unwrap(labels)
    in_len = unwrap(input_lengths)
    lab_len = unwrap(label_lengths)

    def f(lp):
        x = torch.log_softmax(lp.float(), dim=-1)           # [T, B, C]
        T, B, C = x.shape
        dev = x.device
        L = lbl.shape[1]
        S = 2 * L + 1
        lab = lab_len.to(dev).long()
        # extended sequence: blank, l1, blank, l2, ... blank
        ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = lbl.to(dev).long()
        same_as_prev2 = torch.cat(
            [torch.zeros((B, 2), dtype=torch.bool, device=dev),
             ext[:, 2:] == ext[:, :-2]], dim=1)
        bi = torch.arange(B, device=dev)
        neg = torch.full((B, S), NEG, device=dev)
        alpha = torch.cat([
            x[0, bi, ext[:, 0]][:, None],
            torch.where(lab > 0, x[0, bi, ext[:, 1]],
                        torch.full((B,), NEG, device=dev))[:, None],
            neg[:, 2:]], dim=1)
        # blanks (even s) can't skip
        even = (torch.arange(S, device=dev) % 2 == 0)[None, :]
        skip_off = same_as_prev2 | even
        alphas = [alpha]
        for t in range(1, T):
            em = x[t][bi[:, None], ext]                    # [B, S]
            prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
            prev2 = torch.where(skip_off, NEG,
                                torch.cat([neg[:, :2], alpha[:, :-2]], 1))
            alpha = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) + em
            alphas.append(alpha)
        alphas = torch.stack(alphas)                       # [T, B, S]
        # per-sample final time index and final states (2*len-1, 2*len)
        t_idx = torch.clip(in_len.to(dev).long() - 1, 0, T - 1)
        last = alphas[t_idx, bi]                           # [B, S]
        s1 = torch.clip(2 * lab - 1, 0, S - 1)
        s2 = torch.clip(2 * lab, 0, S - 1)
        a1 = torch.gather(last, 1, s1[:, None])[:, 0]
        a2 = torch.gather(last, 1, s2[:, None])[:, 0]
        # empty target: only the all-blank state exists (s1 would alias s2
        # and double-count it)
        ll = torch.where(lab > 0, torch.logaddexp(a1, a2), a2)
        loss = -ll
        if norm_by_times:
            loss = loss / torch.clamp_min(in_len.to(dev).float(), 1.0)
        if reduction == "mean":
            # reference/torch semantics: mean of loss / label_length
            return torch.mean(loss / torch.clamp_min(lab.float(), 1.0))
        return _reduce(loss, reduction)
    return apply_op("ctc_loss", f, log_probs)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T transducer loss (reference loss.py rnnt_loss over warprnnt).
    input [B, T, U+1, C] joint-network logits; alpha DP over the (T, U) grid
    (a loop over t, an inner loop over u) in log domain."""
    lbl = unwrap(label)
    in_len = unwrap(input_lengths)
    lab_len = unwrap(label_lengths)

    def f(lg):
        x = torch.log_softmax(lg.float(), dim=-1)          # [B, T, U1, C]
        B, T, U1, C = x.shape
        dev = x.device
        U = U1 - 1
        bi = torch.arange(B, device=dev)
        blank_lp = x[..., blank]                           # [B, T, U+1]
        if U > 0:
            idx = lbl[:, :U].to(dev).long()                # [B, U]
            y_lp = torch.gather(
                x[:, :, :U, :], 3,
                idx[:, None, :, None].expand(B, T, U, 1))[..., 0]
            if fastemit_lambda:
                # FastEmit (torchaudio semantics): boost label-emission
                # GRADIENTS by (1 + lambda); the loss VALUE is unchanged
                y_lp = (1.0 + fastemit_lambda) * y_lp \
                    - fastemit_lambda * y_lp.detach()
        else:
            y_lp = torch.zeros((B, T, 0), device=dev)      # [B, T, U]

        def label_sweep(from_blank, y_row):
            """Fill one alpha row: u-sequential label moves folded against
            the per-u blank arrivals."""
            cols = [from_blank[:, 0]]
            for u in range(1, U1):
                cols.append(torch.logaddexp(from_blank[:, u],
                                            cols[-1] + y_row[:, u - 1]))
            return torch.stack(cols, dim=1)

        # t = 0 row: no blank arrivals except the (0,0) origin
        neg_row = torch.cat([torch.zeros((B, 1), device=dev),
                             torch.full((B, U), NEG, device=dev)], dim=1)
        alpha = label_sweep(neg_row, y_lp[:, 0])
        rows = [alpha]
        for t in range(1, T):
            alpha = label_sweep(alpha + blank_lp[:, t - 1], y_lp[:, t])
            rows.append(alpha)
        all_alpha = torch.stack(rows)                      # [T, B, U+1]

        t_idx = torch.clip(in_len.to(dev).long() - 1, 0, T - 1)
        u_idx = torch.clip(lab_len.to(dev).long(), 0, U1 - 1)
        final = all_alpha[t_idx, bi, u_idx] + blank_lp[bi, t_idx, u_idx]
        loss = -final
        if reduction == "mean":
            return torch.mean(loss)
        return _reduce(loss, reduction)
    return apply_op("rnnt_loss", f, input)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """reference loss.py adaptive_log_softmax_with_loss (torch-style
    adaptive softmax): head covers [0, cutoffs[0]) + one logit per tail
    cluster; each tail projects down then classifies within its range.
    Returns (per-sample logprob-of-target, mean NLL loss)."""
    lbl = unwrap(label)
    cuts = list(cutoffs)
    args = [input, head_weight] + list(tail_weights or []) \
        + ([head_bias] if head_bias is not None else [])
    n_tail_arrays = len(tail_weights or [])

    def f(x, hw, *rest):
        tails = rest[:n_tail_arrays]
        hb = rest[n_tail_arrays:] if head_bias is not None else ()
        lb = lbl.to(x.device).long()
        x32 = x.float()
        head = x32 @ hw.float()                 # head_weight is [in, out]
        if hb:
            head = head + hb[0].float()
        head_lp = torch.log_softmax(head, dim=1)
        shortlist = cuts[0]
        out = torch.gather(head_lp, 1,
                           torch.clip(lb, 0, shortlist - 1)[:, None])[:, 0]
        in_short = lb < shortlist
        result = torch.where(in_short, out, 0.0)
        for ci in range(len(tails) // 2):
            lo = cuts[ci]
            hi = cuts[ci + 1]
            proj, cls = tails[2 * ci], tails[2 * ci + 1]
            h = x32 @ proj.float()
            tail_logits = h @ cls.float()
            tail_lp = torch.log_softmax(tail_logits, dim=1)
            cluster_lp = head_lp[:, shortlist + ci]
            rel = torch.clip(lb - lo, 0, hi - lo - 1)
            lp = cluster_lp + torch.gather(tail_lp, 1, rel[:, None])[:, 0]
            mask = (lb >= lo) & (lb < hi)
            result = torch.where(mask, lp, result)
        return result, -torch.mean(result)
    return apply_op("adaptive_log_softmax_with_loss", f, *args)
