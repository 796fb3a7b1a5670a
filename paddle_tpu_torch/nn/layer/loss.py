"""Loss layers (reference: python/paddle/nn/layer/loss.py)."""
from __future__ import annotations

from .layers import Layer
from .. import functional as F


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                 name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index, reduction=reduction,
                        soft_label=soft_label, axis=axis, use_softmax=use_softmax,
                        label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index, reduction=reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, **self._kw)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight, self._reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight, self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self._kw = dict(weight=weight, reduction=reduction, pos_weight=pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, **self._kw)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction, self._delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self._reduction, self._log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction, self._log_target)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin, self._reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin, self._reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                 name=None):
        super().__init__()
        self._kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap, reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._kw)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self._margin, self._reduction)
