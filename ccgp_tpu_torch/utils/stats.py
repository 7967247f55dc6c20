"""Statistical helpers (port of `ccgp_tpu/utils/stats.py`): the MVN
log-density through a Cholesky factor, R's type-7 quantiles (with masked
variants for fixed-shape filtering) and batch-means standard errors.
"""
from __future__ import annotations

import torch

from ccgp_tpu_torch.ops import linalg

_LOG2PI = 1.8378770664093453


def mvn_logpdf_chol(y: torch.Tensor, mean, chol: torch.Tensor,
                    log_scale=0.0) -> torch.Tensor:
    """log N(y; mean, C) with C = exp(log_scale) L L', the scalar variance
    factor in log space so the matrix is never scaled (the reference's
    `mnormt::dmnorm(y, mean, s2 * sigma2 * R, log = 1)`)."""
    n = y.shape[-1]
    log_scale = torch.as_tensor(log_scale, dtype=y.dtype, device=y.device)
    w = linalg.tri_solve(chol, y - mean)
    quad = torch.sum(w * w, dim=-1) * torch.exp(-log_scale)
    logdet = linalg.chol_logdet(chol) + n * log_scale
    return -0.5 * (n * _LOG2PI + logdet + quad)


def quantile_type7(x: torch.Tensor, q, dim: int = -1) -> torch.Tensor:
    """R's default (type-7) quantile = linear interpolation."""
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.quantile(x, q, dim=dim, interpolation="linear")


def _interp(xs: torch.Tensor, m: torch.Tensor, q: float) -> torch.Tensor:
    """Type-7 quantile q of each row of the sorted xs, over its first m
    (valid) entries."""
    n = xs.shape[-1]
    h = (m.to(xs.dtype) - 1.0) * q
    lo = torch.clamp(torch.floor(h).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    hi = torch.minimum(hi, torch.clamp_min(m - 1, 0))
    frac = h - lo.to(xs.dtype)
    xlo = torch.gather(xs, -1, lo[..., None])[..., 0]
    xhi = torch.gather(xs, -1, hi[..., None])[..., 0]
    return xlo + frac * (xhi - xlo)


def masked_quantile(x: torch.Tensor, valid: torch.Tensor, q) -> torch.Tensor:
    """Type-7 quantile q of x[valid] per row with fixed shapes: invalid
    entries sorted last, the interpolation over the valid count (the
    reference drops negative-variance draws before its quantiles)."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(valid, x, torch.full_like(x, big)),
                    dim=-1).values
    return _interp(xs, torch.sum(valid, dim=-1), float(q))


def masked_quantile_pair(x: torch.Tensor, valid: torch.Tensor, q_lo,
                         q_hi) -> tuple:
    """Type-7 quantiles q_lo and q_hi of x[valid] per row, from ONE sort
    with invalid entries sorted last (JAX's tail `top_k` selection returns
    the same values)."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(valid, x, torch.full_like(x, big)),
                    dim=-1).values
    m = torch.sum(valid, dim=-1)
    return _interp(xs, m, float(q_lo)), _interp(xs, m, float(q_hi))


def masked_mean(x: torch.Tensor, valid: torch.Tensor,
                dim: int = -1) -> torch.Tensor:
    w = valid.to(x.dtype)
    return torch.sum(x * w, dim=dim) / torch.clamp_min(
        torch.sum(w, dim=dim), 1.0)


def batch_se(x: torch.Tensor, batch_size: int = 20) -> torch.Tensor:
    """Batch-means standard error of the mean (coda::batchSE), over the
    last axis; a trailing partial batch is dropped."""
    n = x.shape[-1]
    nb = n // batch_size
    xb = x[..., :nb * batch_size].reshape(*x.shape[:-1], nb, batch_size)
    var_b = torch.var(torch.mean(xb, dim=-1), dim=-1, correction=1)
    return torch.sqrt(var_b * batch_size / (nb * batch_size))
