"""paddle.metric (reference: python/paddle/metric/metrics.py): counterpart of
``paddle_tpu/metric/__init__.py``.

Metrics accumulate on the host, as the reference's do: each read of a
prediction or a label is a host copy (``_host``), from the card or the CPU,
bfloat16 and float8 as float32."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import unwrap


def _host(x):
    """A Tensor, torch tensor or array-like as a host numpy array."""
    b = unwrap(x)
    if isinstance(b, torch.Tensor):
        b = b.detach()
        if b.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            b = b.float()
        return b.cpu().numpy()
    return np.asarray(b)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _host(pred)
        l = _host(label)
        if l.ndim == p.ndim:
            l = l.squeeze(-1)
        topk_idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        correct = topk_idx == l[..., None]
        return Tensor(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _host(correct)
        num = c.shape[0] if c.ndim else 1
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].sum())
            self.count[i] += num
        return self.total[0] / max(self.count[0], 1)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """ROC-AUC via threshold buckets (reference: metric/metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        p = _host(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = _host(labels).reshape(-1)
        buckets = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                          self.num_thresholds)
        for b, y in zip(buckets, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over descending thresholds
        area = 0.0
        pos = neg = 0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return float(area / (tot_pos * tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    from ..ops.search import topk
    p = unwrap(input)
    l = unwrap(label)
    if l.ndim == p.ndim:
        l = l.squeeze(-1)
    # the port's stable topk: on a tie the lower index wins, as top_k's
    _, idx = topk(input, k)
    correct_mask = (unwrap(idx) == l[..., None]).any(-1)
    return Tensor(correct_mask.to(torch.float32).mean())
