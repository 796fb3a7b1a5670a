"""Gradient clipping: counterpart of ``paddle_tpu/nn/clip.py``
(reference: python/paddle/nn/clip.py).

Each clipper takes and returns a list of ``(parameter, grad)`` pairs, as
the reference's do, over port Tensors or ``torch.Tensor``s: a gradient
comes back as the kind it was given.  Norms are accumulated in float32 on
the device and a scaled gradient is cast back to its own dtype.  A
parameter with ``need_clip = False`` is passed through untouched.

Under a pipeline over launched ranks each rank steps only its own stage's
weights, so ``ClipGradByGlobalNorm`` would see a stage's norm.  The
pipeline's step runs inside :func:`norm_over_stages`, and the global norm
is then summed over the stages, each weight counted once, as the
reference's hybrid-parallel clip does.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.dispatch import unwrap
from ..core.tensor import Tensor, _wrap

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _clips(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _like(g, out):
    """``out`` as the kind of gradient ``g`` is: a Tensor for a Tensor."""
    return _wrap(out) if isinstance(g, Tensor) else out


_STAGES = []     # (group, ids counted on another stage, device) of a step


@contextlib.contextmanager
def norm_over_stages(group, elsewhere, device):
    """Within it, ``ClipGradByGlobalNorm`` all-reduces its sum of squares
    over ``group`` (the pipeline's stages; every rank of it must step) and
    leaves out the weights whose ids are in ``elsewhere`` (a stage's copy
    of a weight an earlier stage owns)."""
    _STAGES.append((group, set(elsewhere), device))
    try:
        yield
    finally:
        _STAGES.pop()


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def __call__(self, params_grads):
        return [(p, _like(g, torch.clamp(unwrap(g), self.min, self.max))
                 if _clips(p, g) else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: scale = min(clip / max(norm, 1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clips(p, g):
                a = unwrap(g)
                af = a.to(torch.float32)
                norm = torch.sqrt(torch.sum(torch.square(af)))
                scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                    max=1.0)
                g = _like(g, (af * scale).to(a.dtype))
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients together: scale = clip / max(global_norm, clip), the
    norm summed in float32 over every clipped gradient."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        stages = _STAGES[-1] if _STAGES else None
        sq = None
        for p, g in params_grads:
            if _clips(p, g) and not (stages and id(p) in stages[1]):
                s = torch.sum(torch.square(unwrap(g).to(torch.float32)))
                sq = s if sq is None else sq + s
        if stages is not None:
            import torch.distributed as dist
            from ..core.sharding import full
            group, _, device = stages
            sq = torch.zeros((), device=device) if sq is None else \
                full(sq).clone()
            dist.all_reduce(sq, group=group.pg)
        if sq is None:
            return params_grads
        global_norm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        out = []
        for p, g in params_grads:
            if _clips(p, g):
                a = unwrap(g)
                g = _like(g, (a.to(torch.float32) * scale).to(a.dtype))
            out.append((p, g))
        return out


def _with_grads(parameters):
    params = [parameters] if isinstance(parameters, (Tensor, torch.Tensor)) \
        else list(parameters)
    return [p for p in params if p.grad is not None]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale every gradient in place by min(max_norm / max(total, 1e-6), 1),
    ``total`` the ``norm_type`` norm of all of them (float32); returns it."""
    params = _with_grads(parameters)
    if not params:
        return _wrap(torch.zeros((), dtype=torch.float32))
    grads = [unwrap(p.grad).to(torch.float32) for p in params]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g)) for g in grads]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(torch.abs(g), norm_type))
                              for g in grads), 1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p, g in zip(params, grads):
        p.grad = _like(p.grad, (g * scale).to(unwrap(p.grad).dtype))
    return _like(params[0], total)


def clip_grad_value_(parameters, clip_value):
    for p in _with_grads(parameters):
        p.grad = _like(p.grad, torch.clamp(unwrap(p.grad), -clip_value,
                                           clip_value))
