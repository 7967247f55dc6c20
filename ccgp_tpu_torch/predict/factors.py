"""Per-draw prediction factor cache (port of `ccgp_tpu/predict/factors.py`).

    L  (m, n, n)   lower Cholesky of R_mix per retained draw
    a  (m, n)      L^-1 (y - beta 1)
    u  (m, n)      L^-1 1
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ccgp_tpu_torch.models.combination import (
    MixParams, MixtureSpec, mixed_gram, unpack)
from ccgp_tpu_torch.ops import chol_lanes, linalg


def decode_stash(fac: torch.Tensor, n: int):
    """Decode sampler-stashed factor rows (m, n+2, n) into (chol, wy, wo):
    row j holds L[i, j] at column i >= j, so the factor is the tril of the
    transpose; row n is L^-1 y and row n+1 is L^-1 1."""
    chol = torch.tril(fac[:, :n, :n].transpose(-1, -2))
    return chol, fac[:, n, :n], fac[:, n + 1, :n]


class FactorCache(NamedTuple):
    chol: torch.Tensor    # (m, n, n)
    a: torch.Tensor       # (m, n)  whitened centered data
    u: torch.Tensor       # (m, n)  whitened ones
    beta: torch.Tensor    # (m,)
    params: MixParams     # batched constrained parameters (leading dim m)


def build_factors(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                  zs: torch.Tensor, betas: torch.Tensor,
                  jitter=0.0) -> FactorCache:
    """zs: (m, n_params) retained unconstrained draws; betas: (m,).

    As in JAX, m >= 64 draws with n <= 128 go to the lanes kernel
    (`ops/chol_lanes.chol_factors_lanes`, K4), which emits L, L^-1 y and
    L^-1 1 in one pass; a = L^-1 (y - beta 1) = wy - beta wo. R_mix has a
    unit diagonal, so the kernel's absolute jitter equals
    `jitter_cholesky`'s mean-diagonal-relative one. Other shapes take the
    plain batched path."""
    params, _ = unpack(spec, zs)
    r = mixed_gram(spec, x, params)
    if chol_lanes.dispatch_ok(zs.shape[0], x.shape[-2]):
        f = chol_lanes.chol_factors_lanes(r, y, jitter=jitter)
        return FactorCache(chol=f["chol"], a=f["wy"] - betas[:, None] * f["wo"],
                           u=f["wo"], beta=betas, params=params)
    chol = linalg.jitter_cholesky(r, jitter)
    a = linalg.tri_solve(chol, y[None, :] - betas[:, None])
    u = linalg.tri_solve(chol, torch.ones_like(a))
    return FactorCache(chol=chol, a=a, u=u, beta=betas, params=params)
