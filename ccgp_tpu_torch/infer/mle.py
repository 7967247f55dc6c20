"""Ordinary-kriging profile-ML fit, the plug-in sigma^2 source (port of
`ccgp_tpu/infer/mle.py:37-147`).

* `kriging_mle` (the default of `fit_combined_gp`): the profile NLL in
  log-theta, minimized by box-constrained multistart BFGS from jittered
  evenly spaced starts, rejecting the all-ones-Gram ridge;
* `kriging_mle_grid`: a dense log-theta grid of 32 Grams, one parabolic
  refinement, then a zoomed grid of 17 (two batched factorizations instead
  of a sequential quasi-Newton chain). Scalar rate only;
* `mlegp_fit` (`ccgp_tpu/infer/mle.py:150-216`): the per-axis (ARD) fit
  that replaces `mlegp::mlegp` in the >= 2-D studies, multistart BFGS from
  the isotropic grid optimum, its per-axis kicks and a Gaussian cloud.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ccgp_tpu_torch.infer.optim import multistart_minimize
from ccgp_tpu_torch.ops import linalg, rng
from ccgp_tpu_torch.ops.chol import chol_quadratics, profile_nll_from_quadratics
from ccgp_tpu_torch.ops.gp import gls_beta, profile_nll, sigma2_mle
from ccgp_tpu_torch.ops.kernels import KernelFamily
from ccgp_tpu_torch.utils import trace


class KrigingMLE(NamedTuple):
    beta: torch.Tensor
    sigma2: torch.Tensor
    theta: torch.Tensor     # scalar rate, or (d,) with ard=True
    nll: torch.Tensor       # profile NLL at the optimum
    chol: torch.Tensor      # Cholesky of the optimal Gram


@trace.span("plugin")
def kriging_mle(family: KernelFamily, x: torch.Tensor, y: torch.Tensor,
                key: torch.Tensor, ard: bool = False, n_starts: int = 8,
                log_theta_low: float = -7.0, log_theta_high: float = 7.0,
                jitter: float = 1e-10, maxiter: int = 100) -> KrigingMLE:
    """Constant-mean GP fit by profile ML over log theta in the box
    [log_theta_low, log_theta_high] (one rate per input axis with
    ard=True). The starts are evenly spaced over the box, each moved by up
    to 0.2 / n_starts of the span by `rng.uniform(key)`, the JAX package's
    stream. A Gram whose largest off-diagonal entry reaches 1 - 1e-6 (the
    degenerate all-ones ridge a global search finds on smooth kernels)
    scores +inf."""
    n, d = x.shape[-2], x.shape[-1]
    k = d if ard else 1
    dt, dev = x.dtype, x.device
    eye = torch.eye(n, dtype=dt, device=dev)

    def nll_of_logtheta(lt):
        theta = torch.exp(lt if ard else lt[0])
        r = family.gram(x, theta)
        chol = linalg.jitter_cholesky(r, jitter)
        nll = profile_nll(chol, y)
        off_max = torch.max(r * (1.0 - eye))
        return torch.where(off_max < 1.0 - 1e-6, nll,
                           torch.full_like(nll, float("inf")))

    span = log_theta_high - log_theta_low
    u = rng.uniform(key.to(dev), (n_starts, k), dt, -1.0, 1.0)
    starts = log_theta_low + span * (
        (torch.arange(n_starts, dtype=dt, device=dev)[:, None] + 0.5)
        / n_starts + 0.2 * u / n_starts)
    starts = torch.clamp(starts, log_theta_low, log_theta_high)
    res = multistart_minimize(
        nll_of_logtheta, starts,
        lower=torch.full((k,), log_theta_low, dtype=dt, device=dev),
        upper=torch.full((k,), log_theta_high, dtype=dt, device=dev),
        maxiter=maxiter)
    theta = torch.exp(res.x if ard else res.x[0])
    chol = linalg.jitter_cholesky(family.gram(x, theta), jitter)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    return KrigingMLE(beta=beta, sigma2=sigma2, theta=theta, nll=res.fun,
                      chol=chol)


@trace.span("plugin")
def kriging_mle_grid(family: KernelFamily, x: torch.Tensor, y: torch.Tensor,
                     log_theta_low: float = -5.0, log_theta_high: float = 6.0,
                     n_grid: int = 32, jitter: float = 1e-10) -> KrigingMLE:
    """Scalar-rate profile-ML fit by a batched log-theta grid plus one
    parabolic refinement and one zoomed grid."""
    n = y.shape[-1]
    dt, dev = x.dtype, x.device
    eye = torch.eye(n, dtype=dt, device=dev)

    def scan(center, half_span, m):
        step = (2.0 * half_span) / (m - 1)
        mg = center + (-half_span + step * torch.arange(m, dtype=dt,
                                                        device=dev))
        grams = family.gram(x, torch.exp(mg)[:, None])
        q = chol_quadratics(grams, y, jitter=jitter)
        nlls = profile_nll_from_quadratics(q, n)
        off_max = torch.amax(grams * (1.0 - eye), dim=(-2, -1))
        inf = torch.full_like(nlls, math.inf)
        nlls = torch.where(off_max < 1.0 - 1e-6, nlls, inf)
        nlls = torch.where(torch.isfinite(nlls), nlls, inf)
        i = int(trace.readback(torch.clamp(torch.argmin(nlls), 1, m - 2)))
        f0, f1, f2 = nlls[i - 1], nlls[i], nlls[i + 1]
        h = mg[1] - mg[0]
        denom = f0 - 2.0 * f1 + f2
        shift = torch.where(torch.abs(denom) > 1e-12,
                            0.5 * h * (f0 - f2) / denom,
                            torch.zeros_like(denom))
        return mg[i] + torch.clamp(shift, -h, h), h

    mid = torch.tensor(0.5 * (log_theta_low + log_theta_high), dtype=dt,
                       device=dev)
    lt, h = scan(mid, 0.5 * (log_theta_high - log_theta_low), n_grid)
    lt, _ = scan(lt, h, 17)
    theta = torch.exp(lt)
    chol = linalg.jitter_cholesky(family.gram(x, theta), jitter)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    return KrigingMLE(beta=beta, sigma2=sigma2, theta=theta,
                      nll=profile_nll(chol, y), chol=chol)


# mlegp_fit's search, JAX's defaults: the log-rate box, the Gaussian
# starts and the BFGS iterations per start
MLEGP_LOG_THETA = (-14.0, 14.0)
MLEGP_N_RANDOM = 12
MLEGP_MAXITER = 300


def mlegp_fit(family: KernelFamily, x: torch.Tensor, y: torch.Tensor,
              key: torch.Tensor | None = None, jitter: float = 1e-10,
              n_random: int = MLEGP_N_RANDOM, maxiter: int = MLEGP_MAXITER,
              log_theta_low: float = MLEGP_LOG_THETA[0],
              log_theta_high: float = MLEGP_LOG_THETA[1]) -> KrigingMLE:
    """ARD Gaussian-correlation GP fit, the framework's `mlegp::mlegp`
    baseline. The starts, in JAX's order (the multistart's argmin keeps the
    first of equal values, so the order matters): the isotropic optimum of
    `kriging_mle_grid` on every axis; then for each axis the kicks +2, -2,
    +4, -4 of its log rate; then n_random Gaussian starts around the
    first, scaled 0.5, 1, 2 in turn (`rng.normal(key)`, key PRNGKey(0)
    when None); all clipped to the box [log_theta_low, log_theta_high]
    and refined by box-constrained BFGS, maxiter iterations each."""
    n, d = x.shape[-2], x.shape[-1]
    dt, dev = x.dtype, x.device
    eye = torch.eye(n, dtype=dt, device=dev)
    iso = kriging_mle_grid(family, x, y, jitter=jitter)

    def nll_of_logtheta(lt):
        r = family.gram(x, torch.exp(lt))
        chol = linalg.jitter_cholesky(r, jitter)
        nll = profile_nll(chol, y)
        off_max = torch.max(r * (1.0 - eye))
        return torch.where(off_max < 1.0 - 1e-6, nll,
                           torch.full_like(nll, float("inf")))

    base = torch.log(iso.theta).expand(d).clone()
    starts = [base]
    for j in range(d):
        for kick in (2.0, -2.0, 4.0, -4.0):
            s = base.clone()
            s[j] = s[j] + kick
            starts.append(s)
    if n_random:
        key = rng.PRNGKey(0, device=dev) if key is None else key.to(dev)
        noise = rng.normal(key, (n_random, d), dt)
        scales = torch.tensor([0.5, 1.0, 2.0] * (n_random // 3 + 1),
                              dtype=dt, device=dev)[:n_random, None]
        starts.extend(base[None, :] + scales * noise)
    lo, hi = log_theta_low, log_theta_high
    res = multistart_minimize(
        nll_of_logtheta, torch.clamp(torch.stack(starts), lo, hi),
        lower=torch.full((d,), lo, dtype=dt, device=dev),
        upper=torch.full((d,), hi, dtype=dt, device=dev),
        maxiter=maxiter)
    theta = torch.exp(res.x)
    chol = linalg.jitter_cholesky(family.gram(x, theta), jitter)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    return KrigingMLE(beta=beta, sigma2=sigma2, theta=theta, nll=res.fun,
                      chol=chol)
