"""Concrete optimizers: counterpart of ``paddle_tpu/optimizer/optimizers.py``
(reference: python/paddle/optimizer/{sgd,momentum,adam,adamw,...}.py).

Every class of the reference, with its update rule term for term.  All
moment math is float32 (bf16-first training contract); parameter updates
cast back to the parameter dtype at the end (master-weights behavior when
multi_precision=True keeps an f32 copy as the source of truth).  Adam and
AdamW update a group at a time with ``torch._foreach_*`` ops (what XLA fused
in the reference; no Pallas kernel computed it); the others a parameter at
a time.  Step counts and beta powers are device tensors, so no update reads
a value back to the host (LBFGS excepted: its line of history is host
control flow, as in the reference).
"""
from __future__ import annotations

import torch

from .optimizer import L1Decay, Optimizer, _leaf

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad", "RMSProp",
           "Adadelta", "Lamb", "LBFGS", "NAdam", "RAdam", "Rprop", "ASGD"]

f32 = torch.float32


def _ones(p):
    return torch.ones((), dtype=f32, device=_leaf(p).device)


def _zeros(p, dtype=f32):
    return torch.zeros((), dtype=dtype, device=_leaf(p).device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = multi_precision

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        g = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        self._commit(p, mw, pw - lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._multi_precision = multi_precision

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        g = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        vel = self._acc("velocity", p, dtype=f32)._data
        v = self._momentum * vel + g
        vel.copy_(v)
        update = g + self._momentum * v if self._nesterov else v
        self._commit(p, mw, pw - lr * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision
        self._amsgrad = amsgrad

    def _decay_is_decoupled(self):
        return False

    def _should_decay(self, p):
        return True

    def _l2(self, pws, gs, wd):
        """The regularizer folded into the float32 gradients, a group at a
        time: L2 adds coeff * p, L1 adds coeff * sign(p)."""
        if wd is None:
            return gs
        coeff = wd.coeff if hasattr(wd, "coeff") else float(wd)
        if isinstance(wd, L1Decay):
            return torch._foreach_add(
                gs, torch._foreach_mul([torch.sign(pw) for pw in pws], coeff))
        return torch._foreach_add(gs, torch._foreach_mul(pws, coeff))

    def _update_group(self, params, grads, lr, wd):
        b1, b2 = self._beta1, self._beta2
        mws, pws = zip(*(self._master(p) for p in params))
        pws = list(pws)
        gs = [g.to(f32) for g in grads]
        if not self._decay_is_decoupled():
            gs = self._l2(pws, gs, wd)
        ms = [self._acc("moment1", p, dtype=f32)._data for p in params]
        vs = [self._acc("moment2", p, dtype=f32)._data for p in params]
        b1p = [self._acc("beta1_pow", p, init=_ones(p))._data for p in params]
        b2p = [self._acc("beta2_pow", p, init=_ones(p))._data for p in params]
        torch._foreach_mul_(b1p, b1)
        torch._foreach_mul_(b2p, b2)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - b2))
        if self._amsgrad:
            vmax = [self._acc("moment2_max", p, dtype=f32)._data for p in params]
            torch._foreach_maximum_(vmax, vs)
            vs = vmax
        # 1 - beta power, one 0-d tensor a parameter
        c1 = torch._foreach_add(torch._foreach_neg(b1p), 1.0)
        c2 = torch._foreach_add(torch._foreach_neg(b2p), 1.0)
        mhat = torch._foreach_div(ms, c1)
        vhat = torch._foreach_div(vs, c2)
        if self._decay_is_decoupled() and wd is not None:
            coeff = wd if isinstance(wd, float) else getattr(wd, "coeff", 0.0)
            keep = 1.0 - lr * coeff
            decay = [i for i, p in enumerate(params) if self._should_decay(p)]
            if decay:
                decayed = torch._foreach_mul([pws[i] for i in decay], keep)
                for i, pw in zip(decay, decayed):
                    pws[i] = pw
        den = torch._foreach_add(torch._foreach_sqrt(vhat), self._eps)
        step = torch._foreach_div(torch._foreach_mul(mhat, lr), den)
        self._commit_all(params, mws, torch._foreach_sub(pws, step))


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py):
    pw * (1 - lr * coeff) before the Adam step, for the parameters
    ``apply_decay_param_fun(name)`` accepts."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_is_decoupled(self):
        return True

    def _should_decay(self, p):
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(self._name_of(p)))
        return True


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        m = self._acc("moment", p, dtype=f32)._data
        u = self._acc("inf_norm", p, dtype=f32)._data
        b1p = self._acc("beta1_pow", p, init=_ones(p))._data
        b1p.mul_(self._beta1)
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(gf)))
        self._commit(p, mw, pw - lr / (1 - b1p) * m / (u + self._eps))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        acc = self._acc("moment", p, init=torch.full(
            _leaf(p).shape, self._init_acc, dtype=f32))._data
        acc.copy_(acc + torch.square(gf))
        self._commit(p, mw, pw - lr * gf / (torch.sqrt(acc) + self._eps))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        ms = self._acc("mean_square", p, dtype=f32)._data
        mom = self._acc("momentum", p, dtype=f32)._data
        ms.copy_(self._rho * ms + (1 - self._rho) * torch.square(gf))
        if self._centered:
            mg = self._acc("mean_grad", p, dtype=f32)._data
            mg.copy_(self._rho * mg + (1 - self._rho) * gf)
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom.copy_(self._momentum * mom + lr * gf / denom)
        self._commit(p, mw, pw - mom)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps, self._rho = epsilon, rho

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        avg_sq = self._acc("avg_squared_grad", p, dtype=f32)._data
        avg_up = self._acc("avg_squared_update", p, dtype=f32)._data
        asv = self._rho * avg_sq + (1 - self._rho) * torch.square(gf)
        update = torch.sqrt(avg_up + self._eps) / torch.sqrt(asv + self._eps) * gf
        auv = self._rho * avg_up + (1 - self._rho) * torch.square(update)
        avg_sq.copy_(asv)
        avg_up.copy_(auv)
        self._commit(p, mw, pw - lr * update)


class Lamb(Optimizer):
    """Layer-wise adaptive moments (reference: python/paddle/optimizer/lamb.py)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn
        self._multi_precision = multi_precision

    def _update_param(self, p, g, lr, wd):
        gf = g.to(f32)
        m = self._acc("moment1", p, dtype=f32)._data
        v = self._acc("moment2", p, dtype=f32)._data
        b1p = self._acc("beta1_pow", p, init=_ones(p))._data
        b2p = self._acc("beta2_pow", p, init=_ones(p))._data
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        v.copy_(self._beta2 * v + (1 - self._beta2) * torch.square(gf))
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        mw, pw = self._master(p)
        r = mhat / (torch.sqrt(vhat) + self._eps)
        if self._exclude_fn is None or not self._exclude_fn(p):
            r = r + self._wd * pw
        w_norm = torch.linalg.vector_norm(pw)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        self._commit(p, mw, pw - lr * trust * r)


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._max_iter = max_iter
        self._history_size = history_size
        self._old_dirs: list = []
        self._old_stps: list = []
        self._prev_flat_grad = None

    @torch.no_grad()
    def step(self, closure=None):
        """Simplified two-loop-recursion L-BFGS (eager-only; host control
        flow: under ``jit.to_static`` capture it is a graph break, and the
        step stays eager)."""
        from ..core.dispatch import _state
        tc = _state.trace_ctx
        if tc is not None and tc.mode == "echo":
            return
        if tc is not None and tc.mode == "capture":
            from ..jit.to_static import GraphBreak
            raise GraphBreak("LBFGS.step reads its line of history on the "
                             "host")
        if closure is not None:
            with torch.enable_grad():
                closure()
        params = [p for p in self._parameter_list if p.grad is not None]
        if not params:
            return
        flat_g = torch.cat([_leaf(p).grad.to(f32).reshape(-1) for p in params])
        if self._prev_flat_grad is not None:
            y = flat_g - self._prev_flat_grad
            s = self._last_step
            ys = torch.dot(y, s)
            if float(ys) > 1e-10:
                self._old_dirs.append(y)
                self._old_stps.append(s)
                if len(self._old_dirs) > self._history_size:
                    self._old_dirs.pop(0)
                    self._old_stps.pop(0)
        q = flat_g
        alphas = []
        for y, s in zip(reversed(self._old_dirs), reversed(self._old_stps)):
            rho = 1.0 / torch.dot(y, s)
            alpha = rho * torch.dot(s, q)
            q = q - alpha * y
            alphas.append((alpha, rho))
        if self._old_dirs:
            y, s = self._old_dirs[-1], self._old_stps[-1]
            q = q * (torch.dot(y, s) / torch.dot(y, y))
        for (alpha, rho), (y, s) in zip(reversed(alphas),
                                        zip(self._old_dirs, self._old_stps)):
            beta = rho * torch.dot(y, q)
            q = q + (alpha - beta) * s
        direction = -q
        lr = self.get_lr()
        self._last_step = lr * direction
        self._prev_flat_grad = flat_g
        offset = 0
        for p in params:
            leaf = _leaf(p)
            n = leaf.numel()
            upd = self._last_step[offset:offset + n].reshape(leaf.shape)
            leaf.copy_(leaf.to(f32) + upd)
            offset += n


class NAdam(Optimizer):
    """reference: optimizer/nadam.py — Adam with Nesterov momentum
    (Dozat 2016; mu-product schedule)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        m = self._acc("moment1", p, dtype=f32)._data
        v = self._acc("moment2", p, dtype=f32)._data
        tacc = self._acc("step", p, init=_zeros(p))._data
        mu_prod = self._acc("mu_product", p, init=_ones(p))._data
        tacc.add_(1.0)
        t = tacc
        mu_t = self._beta1 * (1 - 0.5 * torch.pow(0.96, t * self._psi))
        mu_t1 = self._beta1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * self._psi))
        mu_prod.mul_(mu_t)
        mp = mu_prod
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        v.copy_(self._beta2 * v + (1 - self._beta2) * gf * gf)
        m_hat = mu_t1 * m / (1 - mp * mu_t1) + (1 - mu_t) * gf / (1 - mp)
        v_hat = v / (1 - torch.pow(self._beta2, t))
        self._commit(p, mw, pw - lr * m_hat / (torch.sqrt(v_hat) + self._eps))


class RAdam(Optimizer):
    """reference: optimizer/radam.py — rectified Adam (Liu et al. 2020)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        m = self._acc("moment1", p, dtype=f32)._data
        v = self._acc("moment2", p, dtype=f32)._data
        tacc = self._acc("step", p, init=_zeros(p))._data
        tacc.add_(1.0)
        t = tacc
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        v.copy_(self._beta2 * v + (1 - self._beta2) * gf * gf)
        m_hat = m / (1 - torch.pow(self._beta1, t))
        rho_inf = 2.0 / (1 - self._beta2) - 1.0
        b2t = torch.pow(self._beta2, t)
        rho_t = rho_inf - 2.0 * t * b2t / (1 - b2t)
        # variance rectification: plain momentum until rho_t > 5
        # (reference radam.py:66 and torch both gate at 5); the clamp keeps
        # the unselected branch NaN-free for rho_t in (2, 4)
        num = torch.clamp((rho_t - 4) * (rho_t - 2) * rho_inf, min=0.0)
        r = torch.sqrt(num / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
        v_hat = torch.sqrt(v / (1 - b2t))
        upd = torch.where(rho_t > 5.0, r * m_hat / (v_hat + self._eps), m_hat)
        self._commit(p, mw, pw - lr * upd)


class Rprop(Optimizer):
    """reference: optimizer/rprop.py — resilient backprop (sign-based
    per-weight step sizes; full-batch regime)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None, weight_decay=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        prev = self._acc("prev_grad", p, dtype=f32)._data
        step = self._acc("step_size", p, dtype=f32,
                         init=torch.zeros(_leaf(p).shape, dtype=f32,
                                          device=lr.device) + lr)._data
        sgn = torch.sign(prev * gf)
        factor = torch.where(sgn > 0, self._eta_plus,
                             torch.where(sgn < 0, self._eta_minus, 1.0))
        ns = torch.clamp(step * factor, self._lr_min, self._lr_max)
        g_eff = torch.where(sgn < 0, 0.0, gf)   # backtrack: skip update
        step.copy_(ns)
        prev.copy_(g_eff)
        self._commit(p, mw, pw - ns * torch.sign(g_eff))


class ASGD(Optimizer):
    """reference: optimizer/asgd.py — Stochastic Average Gradient (SAG):
    keep the last-seen gradient y_i per batch slot, maintain their running
    sum d, step with the averaged gradient d / min(m+1, n)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._n = int(max(batch_num, 1))

    def _update_param(self, p, g, lr, wd):
        mw, pw = self._master(p)
        gf = self._apply_weight_decay_l2(pw, g.to(f32), wd)
        n = self._n
        d = self._acc("d", p, dtype=f32)._data
        ys = self._acc("ys", p, init=torch.zeros((n,) + tuple(_leaf(p).shape),
                                                 dtype=f32))._data
        m = self._acc("m", p, init=_zeros(p, torch.int32))._data
        i = (m % n).long().reshape(1)
        yi = torch.index_select(ys, 0, i)[0]
        d.copy_(d - yi + gf)
        ys.index_copy_(0, i, gf[None])
        denom = torch.clamp(m + 1, max=n).to(f32)
        m.add_(1)
        self._commit(p, mw, pw - lr * d / denom)
