"""Batched Cholesky quadratics (port of `ccgp_tpu/ops/pallas_chol.py:216-307`).

`chol_quadratics` is the dispatcher every likelihood scan goes through. As
in JAX, a batch of B >= 64 Grams with n <= 128 goes to the lanes kernel
(`ops/chol_lanes.chol_quadratics_lanes`, K3): the MAP scans and the
empirical-Bayes node sweeps. JAX tests the backend as well and sends
those batches to the kernel on a TPU only; the port sends them on every
device, so a CPU tensor takes the kernel's plain twin. Every other shape
keeps the plain bordered path (the grid kriging MLE's batches of 32 and 17,
the sampler's fallback batches of K <= 16). The small-K and per-matrix
kernels (`chol_quadratics_smallk`, `_chol_nll_pallas`) are still to be
ported (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from ccgp_tpu_torch.ops import chol_lanes, linalg


def chol_quadratics(grams: torch.Tensor, y: torch.Tensor,
                    jitter: float = 0.0) -> dict:
    """Batched {logdet, y'R^-1 y, 1'R^-1 y, 1'R^-1 1}; grams (B, n, n).

    The jitter is absolute (R is a correlation matrix, unit diagonal).
    Outside the lanes kernel's shapes: one bordered factorization per
    matrix (`linalg.bordered_cholesky_quadratics` with zero relative
    jitter)."""
    if chol_lanes.dispatch_ok(grams.shape[0], grams.shape[-1]):
        return chol_lanes.chol_quadratics_lanes(grams, y, jitter=jitter)
    n = grams.shape[-1]
    if jitter:
        grams = grams + jitter * torch.eye(n, dtype=grams.dtype,
                                           device=grams.device)
    q = linalg.bordered_cholesky_quadratics(grams, y, jitter=0.0)
    return {k: q[k] for k in ("logdet", "qyy", "qoy", "qoo")}


def profile_nll_from_quadratics(q: dict, n: int) -> torch.Tensor:
    """log det R + n log sigma2_hat from the quadratic summary."""
    beta = q["qoy"] / q["qoo"]
    n_sigma2 = q["qyy"] - beta * q["qoy"]
    return q["logdet"] + n * torch.log(n_sigma2 / n)


def mvn_nll_from_quadratics(q: dict, n: int, log_scale) -> torch.Tensor:
    """-2 log N(y; beta_hat 1, e^{log_scale} R) + const, per batch element."""
    beta = q["qoy"] / q["qoo"]
    quad = (q["qyy"] - beta * q["qoy"]) * torch.exp(-log_scale)
    return q["logdet"] + n * log_scale + quad
