"""Linalg decompositions closing the paddle.linalg surface gap: counterpart
of ``paddle_tpu/ops/linalg_extra.py`` (reference: python/paddle/tensor/
linalg.py — lu/lu_unpack, ormqr, cond, cholesky_inverse, cdist, low-rank
PCA/SVD, matrix_exp; kernels phi/kernels/impl/lu_kernel_impl.h etc.), on
``torch.linalg``."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap


def lu(x, pivot=True, get_infos=False, name=None):
    """LU factorization; pivots are 1-based row-swap indices (LAPACK ipiv
    convention, matching the reference lu kernel)."""
    if not pivot:
        raise NotImplementedError("lu(pivot=False) is not supported")

    def f(a):
        lu_mat, piv = torch.linalg.lu_factor(a)
        return lu_mat, piv.to(torch.int32)

    out = apply_op("lu", f, x)
    if get_infos:
        lu_mat, piv = out
        b = unwrap(lu_mat)
        info = Tensor(torch.zeros(b.shape[:-2], dtype=torch.int32,
                                  device=b.device))
        return lu_mat, piv, info
    return out


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """Unpack lu() output into (P, L, U)."""
    lu_mat = unwrap(x)
    piv = y.numpy() - 1                   # back to 0-based
    m, n = lu_mat.shape[-2], lu_mat.shape[-1]
    k = min(m, n)

    def f(a):
        L = torch.tril(a[..., :, :k], -1) + torch.eye(m, k, dtype=a.dtype,
                                                      device=a.device)
        U = torch.triu(a[..., :k, :])
        return L, U

    # permutation matrix from the ipiv row swaps
    def _perm_matrix(ipiv):
        perm = np.arange(m)
        for i, j in enumerate(ipiv):
            perm[i], perm[int(j)] = perm[int(j)], perm[i]
        return np.eye(m, dtype=np.float32)[:, perm]

    if piv.ndim == 1:
        P = _perm_matrix(piv)
    else:  # batched: build per-batch permutations
        batch = piv.shape[:-1]
        P = np.zeros(batch + (m, m), np.float32)
        for idx in np.ndindex(*batch):
            P[idx] = _perm_matrix(piv[idx])
    Pt = Tensor(torch.as_tensor(P, device=lu_mat.device))
    L, U = apply_op("lu_unpack", f, x)
    out = []
    if unpack_pivots:
        out.append(Pt)
    if unpack_ludata:
        out.extend([L, U])
    return tuple(out) if len(out) != 1 else out[0]


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """Multiply y by Q from a householder (geqrf-style) factorization."""
    def f(a, t, other):
        q = torch.linalg.householder_product(a, t)
        qm = torch.swapaxes(q, -2, -1) if transpose else q
        return qm @ other if left else other @ qm
    return apply_op("ormqr", f, x, tau, y)


def cond(x, p=None, name=None):
    def f(a):
        if p in (None, 2):
            s = torch.linalg.svdvals(a)
            return s[..., 0] / s[..., -1]
        if p == -2:
            s = torch.linalg.svdvals(a)
            return s[..., -1] / s[..., 0]
        if p in ("fro", "nuc", 1, -1, np.inf, -np.inf):
            return torch.linalg.matrix_norm(a, ord=p) * \
                torch.linalg.matrix_norm(torch.linalg.inv(a), ord=p)
        raise ValueError(f"unsupported p for cond: {p}")
    return apply_op("cond", f, x)


def cholesky_inverse(x, upper=False, name=None):
    def f(a):
        return torch.cholesky_inverse(a, upper=upper)
    return apply_op("cholesky_inverse", f, x)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def f(a, b):
        d = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-30)
        if p == float("inf"):
            return torch.amax(torch.abs(d), dim=-1)
        return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)
    return apply_op("cdist", f, x, y)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Principal components via the dense SVD of the centered matrix (the
    reference's choice over a randomized range finder: exact)."""
    a = unwrap(x)
    m, n = a.shape[-2], a.shape[-1]
    q = q if q is not None else min(6, m, n)

    def f(arr):
        c = arr - torch.mean(arr, dim=-2, keepdim=True) if center else arr
        u, s, vh = torch.linalg.svd(c, full_matrices=False)
        return u[..., :q], s[..., :q], torch.swapaxes(vh, -2, -1)[..., :q]
    return apply_op("pca_lowrank", f, x)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    a = unwrap(x)
    q = min(q, a.shape[-2], a.shape[-1])

    def f(arr, *rest):
        c = arr - rest[0] if rest else arr
        u, s, vh = torch.linalg.svd(c, full_matrices=False)
        return u[..., :q], s[..., :q], torch.swapaxes(vh, -2, -1)[..., :q]
    args = (x, M) if M is not None else (x,)
    return apply_op("svd_lowrank", f, *args)


def matrix_exp(x, name=None):
    """Matrix exponential (reference: phi matrix_exp kernel / paddle.linalg.
    matrix_exp), bf16 computed in float32."""
    def f(arr):
        a32 = arr.float() if arr.dtype == torch.bfloat16 else arr
        return torch.linalg.matrix_exp(a32).to(arr.dtype)
    return apply_op("matrix_exp", f, x)
