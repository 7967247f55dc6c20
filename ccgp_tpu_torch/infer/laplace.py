"""Laplace approximation of the transformed posterior (port of
`ccgp_tpu/infer/laplace.py`): the mode by BFGS on -logpost, the curvature
by `torch.func.hessian` (forward-over-reverse through the Cholesky), then
symmetrization and eigenvalue clipping to a condition number of 1e4. Runs
as the span `laplace`, with `bfgs`, `hessian` and `eigh` inside.
"""
from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import torch

from ccgp_tpu_torch.infer.optim import minimize_bfgs
from ccgp_tpu_torch.utils import trace

# torch.func.hessian's forward mode enters PyTorch's dual levels, which are
# process-wide: two threads in it at once (the shards of
# `parallel.multi_chain_metropolis` on distinct devices) corrupt each
# other's tangents. One Hessian at a time.
_HESSIAN_LOCK = threading.Lock()


class LaplaceFit(NamedTuple):
    mode: torch.Tensor      # posterior mode in the unconstrained space
    cov: torch.Tensor       # inverse negative Hessian at the mode
    logpost: torch.Tensor   # posterior value at the mode


@trace.span("laplace")
def laplace(logpost_val: Callable, start: torch.Tensor,
            maxiter: int = 100) -> LaplaceFit:
    """logpost_val: z -> scalar log-posterior (higher is better)."""

    def neg(z):
        return -logpost_val(z)

    mode, fmin = minimize_bfgs(neg, start, maxiter=maxiter)
    # a NaN mode (the surface NaNs near singular Grams) falls back to start
    if not bool(trace.readback(torch.all(torch.isfinite(mode)))):
        mode = start.detach()
        with torch.no_grad():
            fmin = -logpost_val(mode)
    with _HESSIAN_LOCK, trace.span("hessian"):
        hess = torch.func.hessian(logpost_val)(mode).detach()
    prec = -hess
    prec = 0.5 * (prec + prec.T)
    if not bool(trace.readback(torch.all(torch.isfinite(prec)))):
        prec = torch.eye(prec.shape[-1], dtype=prec.dtype, device=prec.device)
    with trace.span("eigh"):
        w, q = torch.linalg.eigh(prec)
        w_floor = torch.clamp_min(torch.max(torch.abs(w)) * 1e-4, 1e-12)
        w = torch.maximum(w, w_floor)
        cov = (q / w) @ q.T
    return LaplaceFit(mode=mode, cov=cov, logpost=-fmin)
