"""Optimizer base: counterpart of ``paddle_tpu/optimizer/optimizer.py``.

Parameters are torch tensors and their gradients torch's ``.grad``; the
update is Paddle's, not ``torch.optim``'s: accumulators are float32 (as
each optimizer asks), the update is computed in float32 on the master copy
(``multi_precision`` with a bf16 / fp16 parameter) or on the parameter
cast up, and the result is cast down to the parameter's dtype when
committed.  ``step`` clips over all groups at once, so a global-norm clip
sees the true global norm.  Scalars the reference computes in float32
(learning rate, beta powers, decay factors) are computed in float32 here
too.  The elementwise work uses ``torch._foreach_*`` ops: it is what XLA
fused in the reference, and no Pallas kernel computed it.

``parameters`` is a list of tensors, ``named_parameters()`` (then
``apply_decay_param_fun`` receives each parameter's name; otherwise it
receives None), or a list of group dicts (``{"params": ...,
"learning_rate": multiplier, "weight_decay": ...}``).  A learning rate is a
number; the schedulers of ``optimizer/lr.py`` are not ported.
"""
from __future__ import annotations

import numbers
from collections import defaultdict

import numpy as np
import torch

__all__ = ["Optimizer", "L1Decay", "L2Decay"]

f32 = np.float32
# per-parameter scalars kept on the host: reading them never waits for the
# card
_HOST = ("beta1_pow", "beta2_pow")


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "learning-rate schedulers are not ported; pass a number")
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style "
                             "optimizer)")
        self._lr = float(learning_rate)
        self._names = {}                      # id(param) -> name
        self._param_groups = self._build_groups(parameters)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = defaultdict(dict)   # name -> {id(p): tensor}
        self._global_step = 0
        self._multi_precision = False

    def _params_of(self, items):
        out = []
        for it in items:
            if isinstance(it, tuple):
                name, p = it
                self._names[id(p)] = name
                out.append(p)
            else:
                out.append(it)
        return out

    def _build_groups(self, parameters):
        params = list(parameters)
        if params and isinstance(params[0], dict):
            groups = []
            for g in params:
                g = dict(g)
                g["params"] = self._params_of(g["params"])
                groups.append(g)
            return groups
        return [{"params": self._params_of(params)}]

    @property
    def _parameter_list(self):
        return [p for g in self._param_groups for p in g["params"]]

    # ---- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        return float(self._lr)

    def set_lr(self, value):
        self._lr = float(value)

    # ---- accumulators ------------------------------------------------------
    def _acc(self, name, p, init=None):
        """The accumulator ``name`` of ``p``, created on first use as
        float32 zeros of its shape, or as a copy of ``init``, on the
        parameter's device (the beta powers on the host)."""
        store = self._accumulators[name]
        t = store.get(id(p))
        if t is None:
            dev = "cpu" if name in _HOST else p.device
            t = (torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 if init is None else init.to(dev).clone())
            store[id(p)] = t
        return t

    # ---- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        pg = [(p, p.grad) for g in self._param_groups for p in g["params"]
              if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        clipped = {id(p): g for p, g in pg}
        for group in self._param_groups:
            glr = f32(self._lr) * f32(group.get("learning_rate", 1.0))
            wd = group.get("weight_decay", self._weight_decay)
            ps = [p for p in group["params"] if id(p) in clipped]
            if ps:
                self._update_group(ps, [clipped[id(p)] for p in ps], glr, wd)
        self._global_step += 1

    def _update_group(self, params, grads, lr, weight_decay):
        raise NotImplementedError

    # ---- master weights ----------------------------------------------------
    def _master(self, p):
        """(master tensor or None, float32 working value): with
        multi_precision and a bf16 / fp16 parameter, a persistent float32
        master copy is the update's source of truth (else updates under one
        bf16 ulp are lost); otherwise the parameter cast up."""
        if self._multi_precision and p.dtype in (torch.bfloat16,
                                                 torch.float16):
            mw = self._acc("master_weight", p, init=p.detach().float())
            return mw, mw
        return None, p.detach().float()

    def _commit(self, params, masters, values):
        """Store the updated float32 values: a master keeps full
        precision, the parameter gets the cast-down copy."""
        for p, mw, pw in zip(params, masters, values):
            if mw is not None and mw is not pw:
                mw.copy_(pw)
            p.copy_(pw)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    # ---- state dict --------------------------------------------------------
    def state_dict(self):
        """Accumulators keyed ``{name}_{index in the parameter list}`` (the
        reference's keys), plus ``global_step``."""
        sd = {}
        plist = self._parameter_list
        for name, store in self._accumulators.items():
            for i, p in enumerate(plist):
                if id(p) in store:
                    sd[f"{name}_{i}"] = store[id(p)]
        sd["global_step"] = torch.tensor(self._global_step, dtype=torch.int32)
        return sd

    def set_state_dict(self, state_dict):
        plist = self._parameter_list
        for key, value in state_dict.items():
            if key == "LR_Scheduler":
                continue
            if key == "global_step":
                self._global_step = int(value)
                continue
            name, _, idx = key.rpartition("_")
            p = plist[int(idx)]
            v = (value if isinstance(value, torch.Tensor)
                 else torch.as_tensor(np.asarray(value)))
            # a new accumulator takes the SAVED dtype: float32 moments of a
            # bf16 parameter stay float32 on resume
            old = self._accumulators[name].get(id(p))
            self._accumulators[name][id(p)] = v.detach().to(
                device="cpu" if name in _HOST else p.device,
                dtype=v.dtype if old is None else old.dtype).clone()

    def _l2(self, pws, gs, wd):
        """Fold a regularizer into the float32 gradients (Adam-style): L2
        adds coeff * p, L1 adds coeff * sign(p)."""
        if wd is None:
            return gs
        coeff = float(f32(wd.coeff if hasattr(wd, "coeff") else wd))
        if isinstance(wd, L1Decay):
            return torch._foreach_add(
                gs, torch._foreach_mul([pw.sign() for pw in pws], coeff))
        return torch._foreach_add(gs, torch._foreach_mul(pws, coeff))
