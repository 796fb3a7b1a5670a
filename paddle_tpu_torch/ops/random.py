"""Random ops: counterpart of ``paddle_tpu/ops/random.py`` (reference:
python/paddle/tensor/random.py).

Every draw comes from the port's global generator on the tensor's device
(``core/rng.py`` ``next_generator``), or from a fresh one seeded with
``seed`` where an op takes a nonzero seed; none touches torch's own global
state.  The draws are torch's (Philox on the card), so they do not match
the reference's threefry keys: the ops agree in shape, dtype, support and
distribution, and a draw repeats under the same ``paddle.seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.dispatch import unwrap
from ..core.rng import next_generator
from .creation import _norm_shape


def _dt(dtype):
    d = dtypes.convert_dtype(dtype)
    return d if d is not None else dtypes.get_default_dtype()


def _gen(device, seed=None):
    """The generator a draw on ``device`` takes: a fresh one for a given
    seed, else the global generator's."""
    if seed:
        return torch.Generator(device).manual_seed(int(seed))
    return next_generator(device)


def _uniform(shape, device, gen, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32) * (hi - lo) + lo


def _normal(shape, device, gen):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    out = _uniform(_norm_shape(shape), dev, _gen(dev, seed),
                   float(unwrap(min)), float(unwrap(max)))
    return Tensor(out.to(_dt(dtype)))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = current_device()
    return Tensor(_normal(_norm_shape(shape), dev, _gen(dev)).to(_dt(dtype)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = unwrap(mean), unwrap(std)
        dev = (m if isinstance(m, torch.Tensor) else s).device
        sh = torch.broadcast_shapes(tuple(np.shape(m)), tuple(np.shape(s)))
        return Tensor(_normal(sh, dev, _gen(dev)) * s + m)
    dev = current_device()
    out = _normal(_norm_shape(shape), dev, _gen(dev)) * std + mean
    return Tensor(out.to(dtypes.get_default_dtype()))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_device()
    out = _normal(_norm_shape(shape), dev, _gen(dev, seed)) * std + mean
    return Tensor(out.to(_dt(dtype)))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    out = torch.randint(int(unwrap(low)), int(unwrap(high)),
                        _norm_shape(shape), generator=_gen(dev), device=dev)
    return Tensor(out.to(dtypes.convert_dtype(dtype)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    dt = dtype if dtype is not None else x.dtype
    return randint(low, high, tuple(x.shape), dt)


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    out = torch.randperm(int(n), generator=_gen(dev), device=dev)
    return Tensor(out.to(dtypes.convert_dtype(dtype)))


def shuffle(x, name=None):
    a = unwrap(x)
    perm = torch.randperm(a.shape[0], generator=_gen(a.device),
                          device=a.device)
    return Tensor(a[perm])


def bernoulli(x, name=None):
    p = unwrap(x)
    out = torch.bernoulli(p.float(), generator=_gen(p.device))
    return Tensor(out.to(p.dtype))


def bernoulli_(x, p=0.5, name=None):
    b = x._buf
    out = torch.rand(b.shape, generator=_gen(b.device), device=b.device) < p
    x._data = out.to(b.dtype)
    return x


def _standard_gamma(alpha, gen):
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's squeeze method (a
    draw of alpha < 1 boosted from alpha + 1), on ``gen``: the rounds run
    until every element is accepted (each accepts over 95 %)."""
    a = alpha.float()
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a.shape, generator=gen, device=a.device)
        u = torch.rand(a.shape, generator=gen, device=a.device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=gen, device=a.device)
    return torch.where(boost, out * u ** (1.0 / a), out)


def standard_gamma(x, name=None):
    """Sample Gamma(alpha=x, scale=1) elementwise (reference
    tensor/random.py standard_gamma)."""
    alpha = unwrap(x)
    out = _standard_gamma(alpha, _gen(alpha.device))
    keep = alpha.is_floating_point()
    return Tensor(out.to(alpha.dtype if keep else torch.float32))


def poisson(x, name=None):
    lam = unwrap(x)
    out = torch.poisson(lam.float(), generator=_gen(lam.device))
    return Tensor(out.to(lam.dtype))


def binomial(count, prob, name=None):
    n, p = unwrap(count), unwrap(prob)
    out = torch.binomial(n.float(), p.float(), generator=_gen(n.device))
    return Tensor(out.to(torch.int64))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category draws over the last axis of ``x`` (probabilities, not
    necessarily normalised): with replacement through
    ``torch.multinomial``, without through the reference's Gumbel top-k
    over log(max(p, 1e-30)), so a one-hot row always draws its index."""
    probs = unwrap(x)
    gen = _gen(probs.device)
    flat = probs.reshape(-1, probs.shape[-1]).float()
    if replacement:
        out = torch.multinomial(flat, num_samples, replacement=True,
                                generator=gen)
    else:
        logits = torch.log(torch.clamp_min(flat, 1e-30))
        u = torch.rand(flat.shape, generator=gen, device=flat.device)
        g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        out = torch.topk(logits + g, num_samples, dim=-1).indices
    return Tensor(out.reshape(probs.shape[:-1] + (num_samples,)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    b = x._buf
    x._data = _uniform(b.shape, b.device, _gen(b.device, seed), min,
                       max).to(b.dtype)
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    b = x._buf
    x._data = (_normal(b.shape, b.device, _gen(b.device)) * std
               + mean).to(b.dtype)
    return x


def exponential_(x, lam=1.0, name=None):
    b = x._buf
    u = _uniform(b.shape, b.device, _gen(b.device))
    x._data = (-torch.log1p(-u) / lam).to(b.dtype)
    return x


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    dev = current_device()
    out = _normal(_norm_shape(shape), dev, _gen(dev)) * std + mean
    return Tensor(torch.exp(out).to(dtypes.get_default_dtype()))


def cauchy_(x, loc=0, scale=1, name=None):
    b = x._buf
    u = _uniform(b.shape, b.device, _gen(b.device), 1e-6, 1 - 1e-6)
    x._data = (loc + scale * torch.tan(np.pi * (u - 0.5))).to(b.dtype)
    return x


def geometric_(x, probs=0.5, name=None):
    b = x._buf
    u = _uniform(b.shape, b.device, _gen(b.device), 1e-6, 1 - 1e-6)
    p = unwrap(probs)
    p = p if isinstance(p, torch.Tensor) else torch.tensor(
        float(p), device=b.device)
    out = torch.floor(torch.log1p(-u) / torch.log1p(-p)) + 1
    x._data = out.to(b.dtype)
    return x


def log_normal_(x, mean=1.0, std=2.0, name=None):
    b = x._buf
    g = _normal(b.shape, b.device, _gen(b.device))
    x._data = torch.exp(g * std + mean).to(b.dtype)
    return x


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus (top-p) sampling over a probability matrix [batch, vocab]
    (reference: phi/kernels/top_p_sampling_kernel.h). Sorts descending, keeps
    the smallest prefix with cumulative prob >= ps, renormalizes, samples.
    Returns (scores, ids) like the reference."""
    probs = unwrap(x)
    p = unwrap(ps)
    p = (p if isinstance(p, torch.Tensor) else torch.as_tensor(
        np.asarray(p, np.float32))).to(probs.device)
    p = p.reshape(-1, 1) if p.ndim <= 1 else p
    gen = _gen(probs.device, seed if seed not in (-1, None) else None)

    sorted_p, sort_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    # keep tokens whose *preceding* cumulative mass is < p (always >= 1 token)
    keep = (cum - sorted_p) < p
    filtered = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    filtered = filtered / filtered.sum(-1, keepdim=True)
    choice = torch.multinomial(filtered.float(), 1, generator=gen)
    ids = torch.gather(sort_idx, -1, choice)
    scores = torch.gather(probs, -1, ids)
    return Tensor(scores), Tensor(ids)

