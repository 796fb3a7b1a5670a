"""Gradient clipping: counterpart of ``paddle_tpu/nn/clip.py``.

Each clipper takes and returns a list of ``(parameter, grad)`` pairs, as
the reference's do; norms are accumulated in float32 and a scaled gradient
is cast back to its own dtype.  A parameter with ``need_clip = False`` is
passed through untouched.
"""
from __future__ import annotations

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _clips(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clips(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: scale = min(clip / max(norm, 1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clips(p, g):
                gf = g.float()
                norm = gf.square().sum().sqrt()
                scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(
                    1.0)
                g = (gf * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients together: scale = clip / max(global_norm, clip), the
    norm summed in float32 over every clipped gradient."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        sq = None
        for p, g in params_grads:
            if _clips(p, g):
                s = g.float().square().sum()
                sq = s if sq is None else sq + s
        if sq is None:
            return params_grads
        norm = sq.sqrt()
        scale = self.clip_norm / norm.clamp_min(self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype) if _clips(p, g) else g)
                for p, g in params_grads]
