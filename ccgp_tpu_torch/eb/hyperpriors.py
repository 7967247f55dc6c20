"""Empirical-Bayes hyperprior selection by quasi-Monte Carlo marginal
likelihood (port of `ccgp_tpu/eb/hyperpriors.py`).

For each (a1, b1, a2, b2) row of the hyperprior grid,

    ml = E_prior[ N(y; 0, sigma2_t R_mix + tau^2 J) ],   J = all-ones,

over Halton nodes p ~ U(0, 1) with theta_i = qigamma(p; a_i, b_i); the
row with the largest value wins. A row's nodes are one batch of
covariances and one `chol_quadratics` call: 1728 nodes with n <= 128 is
one launch of the lanes kernel (K3). Rows run one after another, one
dispatcher call per row, as the JAX `lax.map` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ccgp_tpu_torch.eb.halton import halton
from ccgp_tpu_torch.models.combination import MixParams, MixtureSpec, mixed_gram
from ccgp_tpu_torch.ops.chol import chol_quadratics
from ccgp_tpu_torch.ops.special import invgamma_quantile
from ccgp_tpu_torch.utils.device import resolve

_LOG2PI = math.log(2.0 * math.pi)


class HyperparChoice(NamedTuple):
    pars: torch.Tensor         # winning (a1, b1, a2, b2)
    index: torch.Tensor        # row index in the grid
    likelihoods: torch.Tensor  # LOG marginal likelihood per grid row


def marginal_likelihood(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                        theta1_pars, theta2_pars, sigma2,
                        nodes: torch.Tensor, tau: float = 100.0,
                        jitter: float = 0.0) -> torch.Tensor:
    """LOG marginal likelihood of one (a1, b1) x (a2, b2) quadruplet.

    nodes (N,) in (0, 1) serve both as the mixing weight p and, through
    the inverse-gamma quantile, as theta1 and theta2 (the reference's node
    construction). The log of the node average by log-sum-exp: the raw
    average the reference takes underflows for bad hyperpriors."""
    a1, b1 = theta1_pars
    a2, b2 = theta2_pars
    p = nodes
    params = MixParams(p=p, theta1=invgamma_quantile(p, a1, b1),
                       theta2=invgamma_quantile(p, a2, b2))
    n = y.shape[-1]
    s2t = sigma2 * (p * p + (1.0 - p) ** 2)
    covs = s2t[:, None, None] * mixed_gram(spec, x, params) + tau * tau
    q = chol_quadratics(covs, y, jitter=jitter)
    ll = -0.5 * (n * _LOG2PI + q["logdet"] + q["qyy"])
    ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))
    return torch.logsumexp(ll, dim=0) - math.log(p.shape[0])


def choose_hyperpars(spec: MixtureSpec, x, y, grid, sigma2,
                     n_nodes: int = 1728, tau: float = 100.0,
                     jitter: float = 0.0, device="cuda") -> HyperparChoice:
    """Scan the (G, 4) hyperprior grid and return the argmax row. x, y and
    the grid are moved to `device` (the GPU unless device="cpu")."""
    dev = resolve(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, dtype=x.dtype, device=dev)
    nodes = torch.as_tensor(halton(n_nodes, 1)[:, 0], dtype=x.dtype,
                            device=dev)
    rows = torch.as_tensor(np.asarray(grid), dtype=x.dtype, device=dev)
    likes = torch.stack([
        marginal_likelihood(spec, x, y, (r[0], r[1]), (r[2], r[3]), sigma2,
                            nodes, tau=tau, jitter=jitter) for r in rows])
    idx = torch.argmax(likes)
    return HyperparChoice(pars=rows[idx], index=idx, likelihoods=likes)
