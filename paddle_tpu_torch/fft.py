"""paddle.fft analog — discrete Fourier transforms: counterpart of
``paddle_tpu/fft.py`` (reference: python/paddle/fft.py over phi fft
kernels).  Each transform is a ``torch.fft`` call routed through
``apply_op``, so autograd, AMP and capture apply; on the card it is cuFFT.

The dtype rules are the reference's (``jnp.fft`` with x64 off): a real or
integer input of the complex transforms and of ``irfft`` / ``hfft`` is
promoted to float32 (``torch.fft`` refuses bf16 on the card and takes f16
only at power-of-two sizes); the real-input transforms (``rfft*``,
``ihfft*``) refuse complex, float16 and bfloat16 inputs as ``jnp.fft``
does; ``fftshift`` keeps its dtype.
"""
from __future__ import annotations

import torch

from .core.dispatch import apply_op
from .core.dtype import convert_dtype
from .core.tensor import Tensor
from .core.device import current_device

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _norm(norm):
    if norm in (None, "backward", "forward", "ortho"):
        return norm
    raise ValueError(f"invalid norm {norm!r}")


def _promote(a):
    """Complex stays; anything else computes in float32."""
    return a if a.is_complex() else a.to(torch.float32)


def _real_input(a, name):
    """The real-input transforms' guard (``jnp.fft.rfft``'s messages)."""
    if a.is_complex():
        raise ValueError(f"only real valued inputs supported for {name}")
    if a.dtype in (torch.float16, torch.bfloat16):
        raise ValueError(f"RFFT input must be float32 or float64, got "
                         f"{str(a.dtype).rsplit('.', 1)[-1]}")
    return a.to(torch.float32)


_REAL_IN = {"rfft", "rfft2", "rfftn", "ihfft"}


def _cast(name, a):
    return _real_input(a, name) if name in _REAL_IN else _promote(a)


def _1d(name, tfn):
    def op(x, n=None, axis=-1, norm="backward", name_=None):
        return apply_op(name, lambda a: tfn(_cast(name, a), n=n, dim=axis,
                                            norm=_norm(norm)), x)
    op.__name__ = name
    return op


def _2d(name, tfn):
    def op(x, s=None, axes=(-2, -1), norm="backward", name_=None):
        return apply_op(name, lambda a: tfn(_cast(name, a), s=s,
                                            dim=tuple(axes),
                                            norm=_norm(norm)), x)
    op.__name__ = name
    return op


def _nd(name, tfn):
    def op(x, s=None, axes=None, norm="backward", name_=None):
        dim = None if axes is None else tuple(axes)
        return apply_op(name, lambda a: tfn(_cast(name, a), s=s, dim=dim,
                                            norm=_norm(norm)), x)
    op.__name__ = name
    return op


fft = _1d("fft", torch.fft.fft)
ifft = _1d("ifft", torch.fft.ifft)
rfft = _1d("rfft", torch.fft.rfft)
irfft = _1d("irfft", torch.fft.irfft)
hfft = _1d("hfft", torch.fft.hfft)
ihfft = _1d("ihfft", torch.fft.ihfft)

fft2 = _2d("fft2", torch.fft.fft2)
ifft2 = _2d("ifft2", torch.fft.ifft2)
rfft2 = _2d("rfft2", torch.fft.rfft2)
irfft2 = _2d("irfft2", torch.fft.irfft2)

fftn = _nd("fftn", torch.fft.fftn)
ifftn = _nd("ifftn", torch.fft.ifftn)
rfftn = _nd("rfftn", torch.fft.rfftn)
irfftn = _nd("irfftn", torch.fft.irfftn)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """Hermitian 2-D fft, the reference's composition: hfft over the last
    axis, then fft over the first, real part."""
    def g(a):
        n0 = None if s is None else s[0]
        n1 = None if s is None else s[1]
        out = torch.fft.hfft(_promote(a), n=n1, dim=axes[1], norm=_norm(norm))
        return torch.fft.fft(out, n=n0, dim=axes[0], norm=_norm(norm)).real
    return apply_op("hfft2", g, x)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    def g(a):
        n0 = None if s is None else s[0]
        n1 = None if s is None else s[1]
        out = torch.fft.ihfft(_real_input(a, "ihfft"), n=n1, dim=axes[1],
                              norm=_norm(norm))
        return torch.fft.ifft(out, n=n0, dim=axes[0], norm=_norm(norm))
    return apply_op("ihfft2", g, x)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    def g(a):
        ax = list(axes) if axes is not None else list(range(a.ndim))
        nlast = None if s is None else s[-1]
        out = torch.fft.hfft(_promote(a), n=nlast, dim=ax[-1],
                             norm=_norm(norm))
        if len(ax) > 1:
            sn = None if s is None else s[:-1]
            out = torch.fft.fftn(out, s=sn, dim=ax[:-1],
                                 norm=_norm(norm)).real
        return out
    return apply_op("hfftn", g, x)


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    def g(a):
        ax = list(axes) if axes is not None else list(range(a.ndim))
        nlast = None if s is None else s[-1]
        out = torch.fft.ihfft(_real_input(a, "ihfft"), n=nlast, dim=ax[-1],
                              norm=_norm(norm))
        if len(ax) > 1:
            sn = None if s is None else s[:-1]
            out = torch.fft.ifftn(out, s=sn, dim=ax[:-1], norm=_norm(norm))
        return out
    return apply_op("ihfftn", g, x)


def _freq(fn, n, d, dtype):
    dt = convert_dtype(dtype) or torch.float32
    return Tensor(fn(n, d=d, dtype=torch.float64,
                     device=current_device()).to(dt))


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def fftshift(x, axes=None, name=None):
    return apply_op("fftshift", lambda a: torch.fft.fftshift(a, dim=axes), x)


def ifftshift(x, axes=None, name=None):
    return apply_op("ifftshift", lambda a: torch.fft.ifftshift(a, dim=axes),
                    x)
