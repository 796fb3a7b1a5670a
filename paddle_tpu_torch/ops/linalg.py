"""Linear algebra ops: counterpart of ``paddle_tpu/ops/linalg.py``
(reference: python/paddle/tensor/linalg.py), on ``torch.linalg``.

The decompositions keep the reference's conventions: ``svd`` returns V
(not V^H), ``eig`` complex eigenpairs, ``eigh`` ascending eigenvalues,
``slogdet`` one stacked [sign, log|det|] tensor.  ``lstsq`` solves through
the pseudo-inverse so that it gives numpy's four outputs on the card too
(torch's card driver returns neither rank nor singular values);
``histogram`` reads the host, as the reference's does.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from .manipulation import _host_out


def _dims(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p=None, axis=None, keepdim=False, name=None):
    def f(a):
        ax = _dims(axis)
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            return torch.sqrt(torch.sum(torch.square(a), dim=ax,
                                        keepdim=keepdim))
        if p == "nuc":
            return torch.linalg.matrix_norm(
                a, "nuc", dim=ax if ax is not None else (-2, -1),
                keepdim=keepdim)
        if p == np.inf or p == -np.inf:
            red = torch.amax if p > 0 else torch.amin
            if ax is None:
                return red(torch.abs(a))
            return red(torch.abs(a), dim=ax, keepdim=keepdim)
        if ax is None:
            a, ax = a.reshape(-1), 0
        return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=ax,
                                   keepdim=keepdim), 1.0 / p)
    return apply_op("p_norm", f, x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply_op("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, ord=p, dim=tuple(axis), keepdim=keepdim), x)


def dist(x, y, p=2, name=None):
    return apply_op("dist", lambda a, b: torch.linalg.vector_norm(
        (a - b).reshape(-1), ord=p), x, y)


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:  # paddle default: first axis with dim 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply_op("cross", f, x, y)


def cholesky(x, upper=False, name=None):
    def f(a):
        L = torch.linalg.cholesky(a)
        return L.mH if upper else L
    return apply_op("cholesky", f, x)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve A X = x given A's Cholesky factor ``y``; only its triangle is
    read, so only the triangle gets a gradient (``cho_solve``'s)."""
    return apply_op("cholesky_solve", lambda b, L: torch.cholesky_solve(
        b, L.triu() if upper else L.tril(), upper=upper), x, y)


def inverse(x, name=None):
    return apply_op("inverse", torch.linalg.inv, x)


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), x)


def solve(x, y, name=None):
    return apply_op("solve", torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        vec = b.ndim == a.ndim - 1
        b = b.unsqueeze(-1) if vec else b
        out = torch.linalg.solve_triangular(
            a.mT if transpose else a, b, upper=upper != transpose,
            unitriangular=unitriangular)
        return out.squeeze(-1) if vec else out
    return apply_op("triangular_solve", f, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """numpy's ``lstsq`` outputs (solution, residuals, rank, singular
    values) through the SVD; residuals are empty unless the matrix has full
    column rank and more rows than columns, as numpy's."""
    a, b = unwrap(x), unwrap(y)
    m, n = a.shape[-2], a.shape[-1]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    eps = torch.finfo(s.dtype).eps
    tol = (rcond if rcond is not None else eps * builtins.max(m, n)) * s[..., :1]
    rank = (s > tol).sum(-1)
    s_inv = torch.where(s > tol, 1.0 / s, torch.zeros_like(s))
    vec = b.ndim == a.ndim - 1
    bb = b.unsqueeze(-1) if vec else b
    sol = vh.mH @ (s_inv[..., None] * (u.mH @ bb))
    if int(rank.min()) == n and m > n:
        res = ((a @ sol - bb) ** 2).sum(-2)
    else:
        res = a.new_zeros((0,))
    sol = sol.squeeze(-1) if vec else sol
    return Tensor(sol), Tensor(res), Tensor(rank), Tensor(s)


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(unwrap(x), mode=mode)
    if mode == "r":
        return Tensor(r)
    return Tensor(q), Tensor(r)


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(unwrap(x), full_matrices=full_matrices)
    return Tensor(u), Tensor(s), Tensor(vh.mH)


def svdvals(x, name=None):
    return Tensor(torch.linalg.svdvals(unwrap(x)))


def eig(x, name=None):
    w, v = torch.linalg.eig(unwrap(x))
    return Tensor(w), Tensor(v)


def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(unwrap(x), UPLO=UPLO)
    return Tensor(w), Tensor(v)


def eigvals(x, name=None):
    return Tensor(torch.linalg.eigvals(unwrap(x)))


def eigvalsh(x, UPLO="L", name=None):
    return Tensor(torch.linalg.eigvalsh(unwrap(x), UPLO=UPLO))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return Tensor(torch.linalg.matrix_rank(unwrap(x), rtol=tol,
                                           hermitian=hermitian))


def matrix_power(x, n, name=None):
    return apply_op("matrix_power",
                    lambda a: torch.linalg.matrix_power(a, n), x)


def slogdet(x, name=None):
    s, ld = torch.linalg.slogdet(unwrap(x))
    return Tensor(torch.stack([s, ld]))


def det(x, name=None):
    return apply_op("det", torch.linalg.det, x)


def multi_dot(x, name=None):
    return apply_op("multi_dot", lambda *arrs: torch.linalg.multi_dot(arrs),
                    *x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw = unwrap(fweights) if fweights is not None else None
    aw = unwrap(aweights) if aweights is not None else None
    return apply_op("cov", lambda a: torch.cov(
        a if rowvar or a.ndim < 2 else a.T, correction=1 if ddof else 0,
        fweights=fw, aweights=aw), x)


def corrcoef(x, rowvar=True, name=None):
    return apply_op("corrcoef", lambda a: torch.corrcoef(
        a if rowvar or a.ndim < 2 else a.T), x)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    device = unwrap(input).device
    rng = None if (min == 0 and max == 0) else (min, max)
    hist, _ = np.histogram(input.numpy(), bins=bins, range=rng,
                           weights=weight.numpy() if weight is not None
                           else None, density=density)
    return _host_out(hist if density else hist.astype(np.int64), device)


def bincount(x, weights=None, minlength=0, name=None):
    a = unwrap(x)
    w = unwrap(weights) if weights is not None else None
    out = torch.bincount(a.long(), weights=w, minlength=minlength)
    return Tensor(out if w is None else out.to(w.dtype))


def householder_product(x, tau, name=None):
    return apply_op("householder_product", torch.linalg.householder_product,
                    x, tau)
