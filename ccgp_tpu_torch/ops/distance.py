"""Pairwise distances (port of `ccgp_tpu/ops/distance.py`).

Squared distances are built from the rank-1 expansion |a|^2 + |b|^2 -
2 a.b and clamped at 0. The inner product must run in full float32: TF32
keeps ~3 decimal digits and breaks the PSD structure of ill-conditioned
SE Grams. PyTorch's default (`torch.backends.cuda.matmul.allow_tf32 =
False`) is what these functions rely on; `chip_smoke.py` sets it
explicitly. The 1-D absolute differences feed the Matern and spline
families.
"""
from __future__ import annotations

import torch


def _weighted(x: torch.Tensor, theta) -> torch.Tensor:
    """Scale coordinates by sqrt(theta) per axis.

    theta is a 0-d rate, or rates of shape (..., d) or (..., 1) whose
    leading axes are a batch (`vmap` in the JAX package): the result is
    then (..., n, d)."""
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    if theta.ndim == 0:
        return x * torch.sqrt(theta)
    return x * torch.sqrt(theta).unsqueeze(-2)


def pairwise_sqdist(x: torch.Tensor, theta=1.0) -> torch.Tensor:
    """D_ij = sum_k theta_k (x_ik - x_jk)^2; x (n, d) -> (..., n, n)."""
    xw = _weighted(x, theta)
    sq = torch.sum(xw * xw, dim=-1)
    inner = torch.matmul(xw, xw.transpose(-1, -2))
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * inner
    return torch.clamp_min(d2, 0.0)


def cross_sqdist(x: torch.Tensor, y: torch.Tensor, theta=1.0) -> torch.Tensor:
    """x (..., n, d), y (..., m, d) -> (..., n, m)."""
    xw = _weighted(x, theta)
    yw = _weighted(y, theta)
    sqx = torch.sum(xw * xw, dim=-1)
    sqy = torch.sum(yw * yw, dim=-1)
    inner = torch.matmul(xw, yw.transpose(-1, -2))
    d2 = sqx[..., :, None] + sqy[..., None, :] - 2.0 * inner
    return torch.clamp_min(d2, 0.0)


def pairwise_absdiff(x: torch.Tensor) -> torch.Tensor:
    """|x_i - x_j| for 1-D inputs x (..., n) -> (..., n, n)."""
    return torch.abs(x[..., :, None] - x[..., None, :])


def cross_absdiff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x_i - y_j| for 1-D inputs: (..., n), (..., m) -> (..., n, m)."""
    return torch.abs(x[..., :, None] - y[..., None, :])
