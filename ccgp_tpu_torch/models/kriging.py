"""Ordinary-kriging (single GP) prediction with Student-t intervals (port
of `ccgp_tpu/models/kriging.py`), the reference's single-GP competitor:

* mean beta + r'R^-1 (y - beta 1) (`1D Codes and Designs/1D Combined GP
  Public.R:548-567`);
* variant "reference" (the 1-D scripts): the universal-kriging variance
  sigma2 (1 - r'R^-1 r + (1 - 1'R^-1 r)^2 / 1'R^-1 1) with the unknown-
  sigma2 Student-t correction Q^2 var / (sigma2 (n - 1)), Q^2 =
  y'(R^-1 - u u' / 1'u) y, u = R^-1 1 (`1D...Public.R:481-539`);
* variant "mlegp" (the >= 2-D scripts, mlegp's se.fit): se = sqrt(sigma2
  (1 - r'R^-1 r)), no mean-correction term, no Q^2 rescaling.

Intervals are mean +/- t_{n-1}(1 - alpha/2) sd (the quantile from
scipy). `fit` is a `infer.mle.KrigingMLE` (duck-typed, as in JAX).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ccgp_tpu_torch.ops import linalg
from ccgp_tpu_torch.ops.kernels import KernelFamily


class KrigingPrediction(NamedTuple):
    mean: torch.Tensor      # (t,)
    var: torch.Tensor       # (t,) t-corrected predictive variance
    lower: torch.Tensor     # (t,)
    upper: torch.Tensor     # (t,)


def _t_quantile(p: float, df: int) -> float:
    import scipy.stats

    return float(scipy.stats.t.ppf(p, df))


def kriging_predict(family: KernelFamily, x: torch.Tensor, y: torch.Tensor,
                    fit, x_new: torch.Tensor, alpha: float = 0.05,
                    variant: str = "reference") -> KrigingPrediction:
    """The single-GP prediction at x_new (t, d) from a profile-ML fit; see
    the module docstring for the two variants."""
    if variant not in ("reference", "mlegp"):
        raise ValueError(variant)
    n = y.shape[-1]
    chol = fit.chol
    a = linalg.tri_solve(chol, y - fit.beta)           # L^-1 (y - beta 1)
    u = linalg.tri_solve(chol, torch.ones_like(y))     # L^-1 1
    v = linalg.tri_solve(chol, family.cross(x, x_new, fit.theta))  # (n, t)
    mean = fit.beta + a @ v
    rinv_quad = torch.sum(v * v, dim=0)
    df = n - 1
    tq = _t_quantile(1.0 - alpha / 2.0, df)
    if variant == "mlegp":
        var_post = fit.sigma2 * (1.0 - rinv_quad)
    else:
        denom = torch.sum(u * u)
        var = fit.sigma2 * (1.0 - rinv_quad + (1.0 - u @ v) ** 2 / denom)
        w = linalg.tri_solve(chol, y)
        q_sq = torch.sum(w * w) - torch.sum(u * w) ** 2 / denom
        var_post = q_sq * var / (fit.sigma2 * df)
    sd_post = torch.sqrt(torch.clamp_min(var_post, 0.0))
    return KrigingPrediction(mean=mean, var=var_post,
                             lower=mean - tq * sd_post,
                             upper=mean + tq * sd_post)
