"""Batched Cholesky quadratics (port of `ccgp_tpu/ops/pallas_chol.py:216-307`).

`chol_quadratics` is the dispatcher every likelihood scan goes through,
in JAX's order: a batch of B >= 64 Grams with n <= 128 goes to the lanes
kernel (`ops/chol_lanes.chol_quadratics_lanes`, K3: the MAP scans and the
empirical-Bayes node sweeps); a batch of B <= 16 inside the small-K
envelope (`ops/chol_smallk.dispatch_ok`) to the small-K kernel
(`chol_quadratics_smallk`, K5: the speculative sampler's K candidates of
a mixture that is not SE/SE); every other shape keeps the plain bordered
path (the grid kriging MLE's batches of 32 and 17). JAX tests the backend
as well and takes the kernels on a TPU only; the port takes them on every
device, so a CPU tensor takes the kernel's plain twin. use_pallas=True
takes the per-matrix kernel instead (`ops/chol_nll.chol_nll`, K9, the
port of `_chol_nll_pallas`) and use_pallas=False the bordered path, as in
JAX; JAX's `interpret` argument is not ported.
"""
from __future__ import annotations

import torch

from ccgp_tpu_torch.ops import chol_lanes, chol_nll, chol_smallk, linalg


def chol_quadratics(grams: torch.Tensor, y: torch.Tensor,
                    jitter: float = 0.0,
                    use_pallas: bool | None = None) -> dict:
    """Batched {logdet, y'R^-1 y, 1'R^-1 y, 1'R^-1 1}; grams (B, n, n).

    The jitter is absolute (R is a correlation matrix, unit diagonal).
    use_pallas=None routes as the module docstring says; True takes the
    per-matrix kernel K9 (n <= 128, else ValueError); False, and every
    shape outside the kernels', one bordered factorization per matrix
    (`linalg.bordered_cholesky_quadratics` with zero relative jitter)."""
    b, n = grams.shape[0], grams.shape[-1]
    if use_pallas:
        return chol_nll.chol_nll(grams, y, jitter=jitter)
    if use_pallas is None:
        if chol_lanes.dispatch_ok(b, n):
            return chol_lanes.chol_quadratics_lanes(grams, y, jitter=jitter)
        if 0 < b <= 16 and chol_smallk.dispatch_ok(n, b):
            return chol_smallk.chol_quadratics_smallk(grams, y,
                                                      jitter=jitter)
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
