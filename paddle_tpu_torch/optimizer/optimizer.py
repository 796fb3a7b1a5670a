"""Optimizer base: counterpart of ``paddle_tpu/optimizer/optimizer.py``
(reference: python/paddle/optimizer/optimizer.py:127).

Parameters are port ``Parameter``s (a ``Tensor`` over a torch leaf) or
``torch.Tensor``s; the update is Paddle's, not ``torch.optim``'s, and is
written into each parameter's torch leaf in place, under ``no_grad``.  A
gradient is the leaf's ``.grad`` (a port parameter's ``.grad`` is a
``Tensor`` over it).  ``step`` clips over all groups at once, so a
global-norm clip sees the true global norm.

``step`` writes state outside ``apply_op``, so inside the echo pass of a
break-stitched ``jit.to_static`` step (``core.dispatch.in_echo``) it does
nothing: the replayed program already stepped.

The optimizer's state is Tensors on the parameters' device, as in the
reference, so a captured step reads and advances it there: the learning
rate ``_lr_t`` (a 0-d float32 tensor; ``set_lr`` and a bound
``LRScheduler``'s ``step`` fill it in place), ``_global_step`` (0-d int32)
and the accumulators (the moments, the per-parameter beta powers, the
float32 master weights under ``multi_precision``).  The update's arithmetic
is float32 whatever the parameter's dtype, on the master copy or on the
parameter cast up, cast down when committed; Python scalars enter it as
float32, as the reference's weakly typed ones do.

``parameters`` is a list of parameters, ``named_parameters()`` pairs (then
``apply_decay_param_fun`` receives each pair's name; otherwise the
parameter's ``name``), or a list of group dicts (``{"params": ...,
"learning_rate": multiplier, "weight_decay": ...}``); a ``Parameter``'s
``optimize_attr["learning_rate"]`` multiplies its rate too.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..core.device import current_device
from ..core.dispatch import in_echo, unwrap
from ..core.tensor import Parameter, Tensor, _wrap

__all__ = ["Optimizer", "L1Decay", "L2Decay"]


def _leaf(p):
    """The torch tensor a parameter's update is written into."""
    return p._buf if isinstance(p, Tensor) else p


def _trainable(p):
    return not p.stop_gradient if isinstance(p, Tensor) else p.requires_grad


def _state(buf, name):
    """A persistable Tensor of optimizer state over ``buf``."""
    t = _wrap(buf)
    t.persistable = True
    t.name = name
    return t


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        from .lr import LRScheduler
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style optimizer)")
        self._names = {}                      # id(param) -> name
        self._param_groups = self._build_groups(parameters)
        self._lr = learning_rate
        self._lr_scheduler = learning_rate if isinstance(learning_rate, LRScheduler) else None
        lr0 = float(self._lr_scheduler()) if self._lr_scheduler is not None else float(learning_rate)
        plist = self._parameter_list
        dev = _leaf(plist[0]).device if plist else current_device()
        self._lr_t = _state(torch.tensor(lr0, dtype=torch.float32, device=dev),
                            "learning_rate")
        if self._lr_scheduler is not None:
            if not hasattr(self._lr_scheduler, "_bound_opts"):
                self._lr_scheduler._bound_opts = []
            self._lr_scheduler._bound_opts.append(self)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: dict[str, dict[int, Tensor]] = defaultdict(dict)
        self._global_step = _state(torch.zeros((), dtype=torch.int32, device=dev),
                                   "global_step")
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

    def _name_of(self, p):
        return self._names.get(id(p), getattr(p, "name", None))

    # ---- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._lr)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value
        self._lr_t._data.fill_(float(value))

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler

    # ---- accumulators --------------------------------------------------------
    def _acc(self, name, p, init=None, dtype=None):
        """The accumulator ``name`` of ``p``, created on first use on the
        parameter's device: zeros of its shape in ``dtype`` (float32 under
        multi_precision, else the parameter's), or a copy of ``init``."""
        store = self._accumulators[name]
        key = id(p)
        if key not in store:
            leaf = _leaf(p)
            dt = dtype or (torch.float32 if self._multi_precision else leaf.dtype)
            buf = torch.zeros(leaf.shape, dtype=dt, device=leaf.device) \
                if init is None else init.detach().to(leaf.device).clone()
            store[key] = _state(buf, f"{name}_{getattr(p, 'name', None) or key}")
        return store[key]

    # ---- step ----------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        if in_echo():        # the replayed program already stepped
            return
        lr = self._lr_t._data
        # clip over ALL groups at once so ClipGradByGlobalNorm sees the true
        # global norm (reference: Optimizer._create_optimization_pass clips the
        # concatenated params_grads)
        all_pg = [(p, p.grad) for g in self._param_groups for p in g["params"]
                  if _trainable(p) and p.grad is not None]
        if self._grad_clip is not None:
            all_pg = self._grad_clip(all_pg)
        clipped = {id(p): unwrap(g) for p, g in all_pg}
        for group in self._param_groups:
            mult = group.get("learning_rate", 1.0)
            glr = lr if mult == 1.0 else lr * mult
            wd = group.get("weight_decay", self._weight_decay)
            by_rate = {}
            for p in group["params"]:
                if id(p) in clipped:
                    m = p.optimize_attr.get("learning_rate", 1.0) \
                        if isinstance(p, Parameter) else 1.0
                    by_rate.setdefault(m, []).append(p)
            for m, ps in by_rate.items():
                self._update_group(ps, [clipped[id(p)] for p in ps],
                                   glr if m == 1.0 else glr * m, wd)
        self._global_step._data.add_(1)

    def _update_group(self, params, grads, lr, weight_decay):
        """Update ``params`` (one group, one rate) from their gradients
        (torch tensors); ``lr`` is a 0-d float32 tensor."""
        for p, g in zip(params, grads):
            self._update_param(p, g, lr, weight_decay)

    def _update_param(self, p, g, lr, weight_decay):
        raise NotImplementedError

    # ---- master weights ------------------------------------------------------
    def _master(self, p):
        """(master_tensor_or_None, f32 working value).

        With multi_precision set and a low-precision parameter, keep a
        persistent f32 master copy as the update's source of truth — otherwise
        updates smaller than one bf16 ulp are permanently lost (reference:
        adamw multi_precision master-weight path,
        python/paddle/optimizer/adamw.py).  The working value may share the
        parameter's storage: updates compute out of place."""
        leaf = _leaf(p)
        if self._multi_precision and leaf.dtype in (torch.bfloat16, torch.float16):
            mw = self._acc("master_weight", p, dtype=torch.float32,
                           init=leaf.to(torch.float32))
            return mw, mw._data
        return None, leaf.detach().to(torch.float32)

    def _commit(self, p, mw, pw):
        """Store the updated f32 value: master keeps full precision, the model
        copy is a cast-down copy, both written in place."""
        self._commit_all([p], [mw], [pw])

    def _commit_all(self, params, masters, values):
        ms = [(mw._data, pw) for mw, pw in zip(masters, values)
              if mw is not None and mw._data is not pw]
        if ms:
            torch._foreach_copy_([m for m, _ in ms], [v for _, v in ms])
        torch._foreach_copy_([_leaf(p) for p in params], list(values))

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if isinstance(p, Tensor):
                p.clear_grad(set_to_zero)
            elif p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # ---- state dict ----------------------------------------------------------
    def state_dict(self):
        sd = {}
        plist = self._parameter_list
        for name, store in self._accumulators.items():
            for i, p in enumerate(plist):
                if id(p) in store:
                    sd[f"{name}_{i}"] = store[id(p)]
        sd["global_step"] = self._global_step
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        plist = self._parameter_list
        for key, value in state_dict.items():
            if key == "LR_Scheduler":
                if self._lr_scheduler is not None:
                    # the scheduler keeps the optimizers bound to it (the
                    # saved state lists the saving run's), and the rate
                    # tensor takes the restored rate at once
                    self._lr_scheduler.set_state_dict(
                        {k: v for k, v in value.items() if k != "_bound_opts"})
                    self._lr_t._data.fill_(float(self._lr_scheduler()))
                continue
            if key == "global_step":
                self._global_step._data.fill_(int(value))
                continue
            name, _, idx = key.rpartition("_")
            p = plist[int(idx)]
            v = unwrap(value) if isinstance(value, (Tensor, torch.Tensor)) \
                else torch.as_tensor(np.asarray(value))
            # a new accumulator keeps the SAVED dtype: creating it with the
            # parameter's would downcast checkpointed f32 Adam moments of a
            # bf16 parameter on resume, degrading training after restart
            store = self._accumulators[name]
            if id(p) in store:
                store[id(p)]._data.copy_(v)
            else:
                self._acc(name, p, init=v)

    def _apply_weight_decay_l2(self, pw, g, wd):
        """Fold regularizer into grad (SGD/Momentum/Adam style): L2 adds coeff*p,
        L1 adds coeff*sign(p) (reference: python/paddle/regularizer.py).
        `pw` is the f32 working value of the parameter (master weight if set)."""
        if wd is None:
            return g
        coeff = wd.coeff if hasattr(wd, "coeff") else float(wd)
        if isinstance(wd, L1Decay):
            return g + coeff * torch.sign(pw)
        return g + coeff * pw


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff
