"""Correlation families (port of `ccgp_tpu/ops/kernels.py`).

* Squared exponential in the rate parameterization r = exp(-sum_k theta_k
  h_k^2). Rates are a 0-d tensor, or (..., d) per-axis / (..., 1)
  isotropic rates with leading batch axes (see `distance._weighted`).
* Matern(nu) on |h| with scale theta:
  r = s^nu K_nu(s) / (Gamma(nu) 2^(nu-1)), s = 2 sqrt(nu) |h| / theta,
  r(0) = 1 (`ops/bessel.py`).
* Nonnegative cubic spline with support [0, theta]:
  1 - 6 u^2 + 6 u^3 for u = |h| / theta <= 1/2, 2 (1 - u)^3 up to 1,
  0 beyond.

Matern and spline take 1-D inputs, (..., n) or (..., n, 1), and a scale
that is a 0-d tensor or a batch (...,) of scalars (the JAX package's vmap
over draws or candidates): the result is then (..., n, m).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ccgp_tpu_torch.ops import distance
from ccgp_tpu_torch.ops.bessel import bessel_kve


def _scalar_rate(th, d2: torch.Tensor) -> torch.Tensor:
    """A 0-d or batched scalar rate (...,) broadcast against (..., n, m)."""
    th = torch.as_tensor(th, dtype=d2.dtype, device=d2.device)
    return th.reshape(th.shape + (1, 1)) if th.ndim else th


# --------------------------------------------------------------------------
# elementwise correlation functions on distances
# --------------------------------------------------------------------------

def matern_corr(absdiff: torch.Tensor, theta, nu: float) -> torch.Tensor:
    """Matern correlation on |h| with scale theta and smoothness nu,
    computed in log space through the scaled Bessel e^s K_nu(s) so that
    large s underflows to 0 without NaNs."""
    nu = float(nu)
    theta = _scalar_rate(theta, absdiff)
    s = 2.0 * math.sqrt(nu) * absdiff / theta
    tiny = 1e-30
    s_safe = torch.clamp_min(s, tiny)
    log_norm = math.lgamma(nu) + (nu - 1.0) * math.log(2.0)
    log_r = (nu * torch.log(s_safe) + torch.log(bessel_kve(nu, s_safe))
             - s_safe - log_norm)
    return torch.where(s <= tiny, torch.ones_like(s), torch.exp(log_r))


def spline_corr(absdiff: torch.Tensor, theta) -> torch.Tensor:
    """Nonnegative cubic-spline correlation with support [0, theta]."""
    theta = _scalar_rate(theta, absdiff)
    u = absdiff / theta
    inner = 1.0 - 6.0 * u * u + 6.0 * u * u * u
    om = torch.clamp_min(1.0 - u, 0.0)
    outer = 2.0 * om * om * om
    return torch.where(u <= 0.5, inner, outer)


# --------------------------------------------------------------------------
# Gram and cross-correlation functions
# --------------------------------------------------------------------------

def sqexp_gram(x: torch.Tensor, theta) -> torch.Tensor:
    """SE Gram with the unit diagonal enforced exactly: (..., n, n)."""
    g = torch.exp(-distance.pairwise_sqdist(x, theta))
    eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    return g * (1.0 - eye) + eye


def sqexp_cross(x: torch.Tensor, y: torch.Tensor, theta) -> torch.Tensor:
    """SE cross-correlation: (n, d), (m, d) -> (..., n, m)."""
    return torch.exp(-distance.cross_sqdist(x, y, theta))


def _one_d(x: torch.Tensor) -> torch.Tensor:
    """(..., n, 1) -> (..., n); (..., n) as it is."""
    return x[..., 0] if x.ndim >= 2 and x.shape[-1] == 1 else x


def _scale(th):
    """A scale in the (..., 1) layout `mixed_gram` passes to a family's
    gram/cross (a scalar rate gains an axis there) back to (...,)."""
    th = torch.as_tensor(th)
    return th[..., 0] if th.ndim and th.shape[-1] == 1 else th


def matern_gram(x: torch.Tensor, theta, nu: float) -> torch.Tensor:
    """Matern Gram for 1-D inputs x: (..., n) or (..., n, 1)."""
    return matern_corr(distance.pairwise_absdiff(_one_d(x)), _scale(theta),
                       nu)


def matern_cross(x: torch.Tensor, y: torch.Tensor, theta,
                 nu: float) -> torch.Tensor:
    return matern_corr(distance.cross_absdiff(_one_d(x), _one_d(y)),
                       _scale(theta), nu)


def spline_gram(x: torch.Tensor, theta) -> torch.Tensor:
    """Cubic-spline Gram for 1-D inputs."""
    return spline_corr(distance.pairwise_absdiff(_one_d(x)), _scale(theta))


def spline_cross(x: torch.Tensor, y: torch.Tensor, theta) -> torch.Tensor:
    return spline_corr(distance.cross_absdiff(_one_d(x), _one_d(y)),
                       _scale(theta))


# --------------------------------------------------------------------------
# kernel family objects
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelFamily:
    """A stationary correlation family with a rate or scale parameter
    (SE uses rates, larger = rougher; Matern and spline scales, smaller =
    rougher).

    `raw_kind` / `raw` / `raw_cross` / `corr_from_raw` expose the
    theta-independent distance pass two families can share; for SE,
    `corr_from_raw` takes a scalar (isotropic) rate only."""

    name: str
    gram: Callable
    cross: Callable
    raw_kind: str
    raw: Callable
    raw_cross: Callable
    corr_from_raw: Callable


def sqexp_family() -> KernelFamily:
    return KernelFamily(
        "sqexp", sqexp_gram, sqexp_cross,
        raw_kind="sqdist",
        raw=lambda x: distance.pairwise_sqdist(x, 1.0),
        raw_cross=lambda x, y: distance.cross_sqdist(x, y, 1.0),
        corr_from_raw=lambda d2, th: torch.exp(-_scalar_rate(th, d2) * d2),
    )


def _absdiff_raw(x):
    return distance.pairwise_absdiff(_one_d(x))


def _absdiff_raw_cross(x, y):
    return distance.cross_absdiff(_one_d(x), _one_d(y))


def matern_family(nu: float) -> KernelFamily:
    nu = float(nu)
    return KernelFamily(
        f"matern{nu:g}",
        lambda x, th: matern_gram(x, th, nu),
        lambda x, y, th: matern_cross(x, y, th, nu),
        raw_kind="absdiff",
        raw=_absdiff_raw,
        raw_cross=_absdiff_raw_cross,
        corr_from_raw=lambda h, th: matern_corr(h, th, nu),
    )


def spline_family() -> KernelFamily:
    return KernelFamily(
        "spline", spline_gram, spline_cross,
        raw_kind="absdiff",
        raw=_absdiff_raw,
        raw_cross=_absdiff_raw_cross,
        corr_from_raw=spline_corr,
    )
