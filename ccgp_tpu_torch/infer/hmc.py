"""Hamiltonian Monte Carlo over the unconstrained posterior (port of
`ccgp_tpu/infer/hmc.py`; no reference analogue: the reference's only
sampler is the random-walk Metropolis).

* Laplace preconditioning: the sampler runs in the whitened space
  u = C^-1 z, C the Cholesky factor of `mass_cov` (pass `LaplaceFit.cov`),
  with standard normal momentum.
* Dual-averaging step-size adaptation (Hoffman & Gelman 2014, section
  3.2) over `n_warmup` iterations towards `target_accept`; the averaged
  step size is frozen for sampling.
* NaN-as-divergence: a singular Gram gives a NaN or -inf log-posterior
  and a NaN gradient (the port's log-posteriors factor with
  `cholesky_ex` and mask, they never raise); a non-finite trajectory or a
  Hamiltonian error beyond `divergence_thresh` zeroes the acceptance
  probability.

Gradients come from `torch.autograd` on `logpost_val`; the draws from
the port's plain `rng.split` / `normal` / `uniform` in JAX's order (JAX's
HMC reaches no Pallas kernel). Starts (c, dim) and keys (c, 2) run c
chains side by side, the counterpart of `jax.vmap(hmc)`: logpost_val then
takes (c, dim) and returns (c,) (`make_logpost(...)(z).val` does), and
chain i follows its own single run.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ccgp_tpu_torch.ops import rng


class HMCResult(NamedTuple):
    samples: torch.Tensor      # (..., n_samples, dim) unconstrained draws
    logposts: torch.Tensor     # (..., n_samples)
    accept_rate: torch.Tensor  # (...,) mean acceptance prob, sampling
    step_size: torch.Tensor    # (...,) adapted (whitened-space) step size
    n_divergent: torch.Tensor  # (...,) divergent transitions, sampling


def _mv(chol: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """chol @ u over the chains' axes, as an elementwise product and a row
    sum: the same arithmetic for one chain and for a batch of them (a
    broadcast matmul would change the summation with the batch)."""
    return torch.sum(chol * u[..., None, :], dim=-1)


def _forward_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """chol^-1 b by forward substitution, row by row (the same arithmetic
    for one chain and for a batch)."""
    u = []
    for k in range(b.shape[-1]):
        acc = b[..., k]
        for j in range(k):
            acc = acc - chol[..., k, j] * u[j]
        u.append(acc / chol[..., k, k])
    return torch.stack(u, dim=-1)


def _leapfrog(vg: Callable, u, p, g, eps, n_steps: int):
    """n_steps leapfrog steps; returns (u, p, logpost(u), grad(u)). eps
    has the chains' shape (...,)."""
    e = eps[..., None]
    lp = torch.zeros_like(eps)
    for _ in range(n_steps):
        p = p + 0.5 * e * g
        u = u + e * p
        lp, g = vg(u)
        p = p + 0.5 * e * g
    return u, p, lp, g


def hmc(logpost_val: Callable, start: torch.Tensor, key: torch.Tensor,
        n_samples: int, n_warmup: int = 500, n_leapfrog: int = 16,
        mass_cov: torch.Tensor | None = None, target_accept: float = 0.8,
        init_step_size: float = 0.1,
        divergence_thresh: float = 1000.0) -> HMCResult:
    """Sample `n_samples` draws after `n_warmup` adaptation iterations.

    logpost_val: z -> log-posterior (higher is better; -inf or NaN for an
    invalid state). start (dim,) and key (2,), or (c, dim) and (c, 2) for c
    chains. mass_cov: the position-space covariance for preconditioning
    (typically `laplace(...).cov`); the identity if None."""
    dim = start.shape[-1]
    dtype, dev = start.dtype, start.device
    key = key.to(dev)
    if mass_cov is None:
        chol = torch.eye(dim, dtype=dtype, device=dev)
    else:
        chol = torch.linalg.cholesky(mass_cov.to(dtype=dtype, device=dev))

    def vg(u):
        with torch.enable_grad():
            u = u.detach().requires_grad_(True)
            lp = logpost_val(_mv(chol, u))
            g, = torch.autograd.grad(lp.sum(), u)
        return lp.detach(), g

    def transition(u, lp, g, eps, key):
        ks = rng.split(key)
        kp, ka = ks[..., 0, :], ks[..., 1, :]
        p = rng.normal(kp, (dim,), dtype)
        h0 = lp - 0.5 * torch.sum(p * p, dim=-1)
        u1, p1, lp1, g1 = _leapfrog(vg, u, p, g, eps, n_leapfrog)
        h1 = lp1 - 0.5 * torch.sum(p1 * p1, dim=-1)
        delta = h1 - h0
        finite = (torch.isfinite(delta)
                  & torch.all(torch.isfinite(u1), dim=-1)
                  & torch.all(torch.isfinite(g1), dim=-1))
        divergent = ~finite | (delta < -divergence_thresh)
        alpha = torch.where(
            divergent, torch.zeros_like(delta),
            torch.minimum(torch.ones_like(delta),
                          torch.exp(torch.clamp_max(delta, 0.0))))
        acc = rng.uniform(ka, (), dtype) < alpha
        u = torch.where(acc[..., None], u1, u)
        lp = torch.where(acc, lp1, lp)
        g = torch.where(acc[..., None], g1, g)
        return u, lp, g, alpha, divergent

    u = _forward_solve(chol, start.to(dev))
    lp, g = vg(u)
    lead = start.shape[:-1]

    # ---- warmup: dual averaging of the log step size ---------------------
    gamma, t0, kappa = 0.05, 10.0, 0.75
    mu = torch.log(10.0 * torch.full(lead, init_step_size, dtype=dtype,
                                     device=dev))
    log_eps = torch.log(torch.full(lead, init_step_size, dtype=dtype,
                                   device=dev))
    log_eps_bar = log_eps
    h_bar = torch.zeros(lead, dtype=dtype, device=dev)
    for m in range(1, n_warmup + 1):
        ks = rng.split(key)
        key, kt = ks[..., 0, :], ks[..., 1, :]
        u, lp, g, alpha, _ = transition(u, lp, g, torch.exp(log_eps), kt)
        mf = torch.tensor(float(m), dtype=dtype, device=dev)
        h_bar = ((1.0 - 1.0 / (mf + t0)) * h_bar
                 + (target_accept - alpha) / (mf + t0))
        log_eps = mu - torch.sqrt(mf) / gamma * h_bar
        eta = mf ** -kappa
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
    eps = torch.exp(log_eps_bar)

    # ---- sampling: frozen step size ---------------------------------------
    keys = rng.split(key, n_samples)
    zs, lps, alphas, divs = [], [], [], []
    for t in range(n_samples):
        u, lp, g, alpha, div = transition(u, lp, g, eps, keys[..., t, :])
        zs.append(_mv(chol, u))
        lps.append(lp)
        alphas.append(alpha)
        divs.append(div)
    alphas = torch.stack(alphas, dim=-1)
    return HMCResult(samples=torch.stack(zs, dim=-2),
                     logposts=torch.stack(lps, dim=-1),
                     accept_rate=torch.mean(alphas, dim=-1),
                     step_size=eps,
                     n_divergent=torch.sum(torch.stack(divs, dim=-1)
                                           .to(torch.int32), dim=-1))
