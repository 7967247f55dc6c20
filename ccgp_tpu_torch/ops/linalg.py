"""Cholesky-centric linear algebra (port of `ccgp_tpu/ops/linalg.py`).

A failed factorization is NaN, never an exception: `torch.linalg.cholesky`
raises on a non-PD matrix, so the port factors with `cholesky_ex` and
NaN-masks the whole lower triangle where `info != 0`, as JAX's
Cholesky does on the CPU (`ccgp_tpu/ops/linalg.py:21-36`). NaN flows to a
log-posterior of -inf, which the sampler rejects.

All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import torch


def _add_diag(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a + v I for a batched scalar v (...,). A 0-d v is not indexed: a view
    of a 0-d tensor breaks torch.func.hessian in float32."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return a + (v if v.ndim == 0 else v[..., None, None]) * eye


def _nan_masked_cholesky(a: torch.Tensor) -> torch.Tensor:
    chol, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, chol, torch.tril(torch.full_like(chol, float("nan"))))


def jitter_cholesky(a: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Lower Cholesky of a PSD matrix with diagonal jitter relative to the
    mean diagonal; NaN where the factorization failed."""
    if not (isinstance(jitter, (int, float)) and jitter == 0.0):
        scale = torch.mean(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
        a = _add_diag(a, jitter * scale)
    return _nan_masked_cholesky(a)


def bordered_cholesky_quadratics(a: torch.Tensor, y: torch.Tensor,
                                 jitter: float = 0.0) -> dict:
    """One (n+2)-Cholesky of M = [[A, B], [B', c I]], B = [y, 1], gives the
    factor, log det A and qyy = y'A^-1 y, qoy = 1'A^-1 y, qoo = 1'A^-1 1
    (read off the border rows: W = L^-1 B).

    The border constant keeps M PSD: c = (|y|^2 + n) / (jitter * scale),
    or with jitter = 0 the floor n * eps(dtype) in the denominator
    (`ccgp_tpu/ops/linalg.py:53-81`). A failed factorization NaN-masks the
    ENTIRE factor, as potrf does under JAX, so c is ported exactly."""
    n = a.shape[-1]
    dtype, dev = a.dtype, a.device
    if jitter:
        scale = torch.mean(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
        a = _add_diag(a, jitter * scale)
        lam = jitter * scale[..., None]                      # (..., 1)
    else:
        lam = n * float(torch.finfo(dtype).eps)
    y = torch.broadcast_to(y, a.shape[:-2] + (n,))
    ones = torch.ones_like(y)
    b = torch.stack([y, ones], dim=-1)                       # (..., n, 2)
    c = (torch.sum(y * y, dim=-1, keepdim=True) + n) / lam   # (..., 1)
    d = c[..., None] * torch.eye(2, dtype=dtype, device=dev)  # (..., 2, 2)
    m = torch.cat([torch.cat([a, b], dim=-1),
                   torch.cat([b.transpose(-1, -2), d], dim=-1)], dim=-2)
    lf = _nan_masked_cholesky(m)
    chol = lf[..., :n, :n]
    wy = lf[..., n, :n]
    wo = lf[..., n + 1, :n]
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return {
        "chol": chol,
        "logdet": logdet,
        "qyy": torch.sum(wy * wy, dim=-1),
        "qoy": torch.sum(wy * wo, dim=-1),
        "qoo": torch.sum(wo * wo, dim=-1),
    }


def tri_solve(chol: torch.Tensor, b: torch.Tensor, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Batched triangular solve; b may be (..., n) or (..., n, k)."""
    vec = b.ndim == chol.ndim - 1
    if vec:
        b = b[..., None]
    if trans:
        chol = chol.transpose(-1, -2)
        lower = not lower
    out = torch.linalg.solve_triangular(chol, b, upper=not lower)
    return out[..., 0] if vec else out


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor of A."""
    return tri_solve(chol, tri_solve(chol, b), trans=True)


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log det A from its lower Cholesky factor."""
    return 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def solve_psd(a: torch.Tensor, b: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Solve A x = b for PSD A through its Cholesky factor (NaN where the
    factorization failed)."""
    return chol_solve(jitter_cholesky(a, jitter), b)


def logdet_psd(a: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """log det A for PSD A through its Cholesky factor (NaN where the
    factorization failed)."""
    return chol_logdet(jitter_cholesky(a, jitter))


def schur_complement(r_new: torch.Tensor, r_cross: torch.Tensor,
                     chol_old: torch.Tensor) -> torch.Tensor:
    """R_new - R_cross R_old^-1 R_cross' for r_cross (m, n_old) and the
    lower Cholesky factor of R_old: the conditional covariance of a new
    batch given the old one, without forming R_old^-1."""
    w = tri_solve(chol_old, r_cross.transpose(-1, -2))      # (n_old, m)
    return r_new - torch.einsum("...ki,...kj->...ij", w, w)


def augmented_logdet(r_new: torch.Tensor, r_cross: torch.Tensor,
                     chol_old: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """log det [[R_old, R_cross'], [R_cross, R_new]] - log det R_old, the
    log det of the Schur complement."""
    return logdet_psd(schur_complement(r_new, r_cross, chol_old), jitter)
