"""Adam and AdamW: counterpart of ``paddle_tpu/optimizer/optimizers.py``.

Moments are float32 whatever the parameter's dtype, so a bf16 model trains
with float32 moments (``torch.optim.AdamW`` would keep them in bf16); the
update runs in float32 and is cast down when committed (see
:mod:`.optimizer`).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, f32

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision
        self._amsgrad = amsgrad

    def _decay_is_decoupled(self):
        return False

    def _should_decay(self, p):
        return True

    def _pow(self, name, p, beta):
        """Advance the float32 beta power of ``p``; returns the new value."""
        acc = self._acc(name, p, init=torch.ones((), dtype=torch.float32))
        t = f32(acc.item()) * f32(beta)
        acc.fill_(float(t))
        return t

    def _update_group(self, params, grads, lr, wd):
        b1, b2 = f32(self._beta1), f32(self._beta2)
        mws, pws = zip(*(self._master(p) for p in params))
        pws = list(pws)
        gs = [g.float() for g in grads]
        if not self._decay_is_decoupled():
            gs = self._l2(pws, gs, wd)
        ms = [self._acc("moment1", p) for p in params]
        vs = [self._acc("moment2", p) for p in params]
        b1t = [self._pow("beta1_pow", p, b1) for p in params]
        b2t = [self._pow("beta2_pow", p, b2) for p in params]
        torch._foreach_mul_(ms, float(b1))
        torch._foreach_add_(ms, torch._foreach_mul(gs, float(f32(1) - b1)))
        torch._foreach_mul_(vs, float(b2))
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), float(f32(1) - b2)))
        if self._amsgrad:
            vmax = [self._acc("moment2_max", p) for p in params]
            torch._foreach_maximum_(vmax, vs)
            vs = vmax
        mhat = torch._foreach_div(ms, [float(f32(1) - t) for t in b1t])
        vhat = torch._foreach_div(vs, [float(f32(1) - t) for t in b2t])
        if self._decay_is_decoupled() and wd is not None:
            coeff = wd if isinstance(wd, float) else getattr(wd, "coeff",
                                                             0.0)
            keep = float(f32(1) - lr * f32(coeff))
            pws = [pw * keep if self._should_decay(p) else pw
                   for p, pw in zip(params, pws)]
        den = torch._foreach_add(torch._foreach_sqrt(vhat), float(self._eps))
        step = torch._foreach_div(torch._foreach_mul(mhat, float(lr)), den)
        self._commit(params, mws, torch._foreach_sub(pws, step))


class AdamW(Adam):
    """Decoupled weight decay: pw * (1 - lr * coeff) before the Adam step,
    for the parameters ``apply_decay_param_fun(name)`` accepts."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_is_decoupled(self):
        return True

    def _should_decay(self, p):
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(self._names.get(id(p))))
        return True
