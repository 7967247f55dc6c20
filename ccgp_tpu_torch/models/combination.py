"""Convex-combination covariance (port of `ccgp_tpu/models/combination.py`).

    R_mix = (p^2 R1 + (1-p)^2 R2) / (p^2 + (1-p)^2)

Parameters may carry leading batch axes (draws, candidates) where the JAX
package vmaps: p (...,), theta1 (...,) isotropic or (..., d) anisotropic,
theta2 (...,). Grams and cross blocks then come out as (..., n, m).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ccgp_tpu_torch.ops import distance
from ccgp_tpu_torch.ops.kernels import KernelFamily
from ccgp_tpu_torch.utils import transforms


class MixParams(NamedTuple):
    """Constrained mixture parameters (see `ccgp_tpu.models.combination`):
    p in (0, 1), theta1 the smooth rate, theta2 the rough rate ('free') or
    lambda ('tied': rough rate (1 + lambda) theta1; 'lambda': lambda used
    directly as the training rate)."""

    p: torch.Tensor
    theta1: torch.Tensor
    theta2: torch.Tensor


@dataclass(frozen=True)
class MixtureSpec:
    """Static description of a combined-GP covariance."""

    kernel1: KernelFamily
    kernel2: KernelFamily
    dim: int = 1
    rough: str = "free"          # 'free' | 'tied' | 'lambda'
    anisotropic: bool = False    # theta1 is a per-axis (dim,) vector

    @property
    def n_params(self) -> int:
        """Length of the unconstrained sampling vector z."""
        return (self.dim if self.anisotropic else 1) + 2

    def __post_init__(self):
        if self.rough not in ("free", "tied", "lambda"):
            raise ValueError(f"unknown rough mode {self.rough!r}")
        if (self.rough in ("tied", "lambda")
                and self.kernel1.name != self.kernel2.name):
            raise ValueError("tied/lambda rough modes require a shared family")


def mix_weights(p):
    """(w1, w2, s) with w1 = p^2, w2 = (1-p)^2, s = w1 + w2."""
    w1 = p * p
    w2 = (1.0 - p) * (1.0 - p)
    return w1, w2, w1 + w2


def _effective_rates(spec: MixtureSpec, params: MixParams, predict: bool):
    """Rates fed to (kernel1, kernel2) for Gram / cross construction."""
    th1, th2 = params.theta1, params.theta2
    if spec.rough == "free":
        return th1, th2
    if spec.rough == "tied":
        lam1 = 1.0 + th2
        if spec.anisotropic:
            lam1 = lam1[..., None]
        return th1, lam1 * th1
    if predict:
        lam1 = 1.0 + th2
        if spec.anisotropic:
            lam1 = lam1[..., None]
        return th1, th1 * lam1
    return th1, th2


def _axis_rates(spec: MixtureSpec, th, params: MixParams):
    """A rate in the (..., d) / (..., 1) layout `ops.distance` takes: a
    per-axis rate keeps its axis, a scalar rate gains one."""
    if spec.anisotropic and th.ndim == params.theta1.ndim:
        return th
    return th[..., None]


def _bcast(v: torch.Tensor) -> torch.Tensor:
    """A batched scalar (...,) against (..., n, m) blocks. A 0-d tensor is
    left as it is: a view of it breaks torch.func.hessian in float32."""
    return v if v.ndim == 0 else v[..., None, None]


def _mixed_from_shared_raw(spec: MixtureSpec, raw: torch.Tensor, p,
                           r1_theta, r2_theta) -> torch.Tensor:
    """R_mix from one theta-independent distance pass shared by both
    families (the squared distances of isotropic SE, or the 1-D absolute
    differences of Matern and spline)."""
    w1, w2, s = mix_weights(p)
    r1 = spec.kernel1.corr_from_raw(raw, r1_theta)
    r2 = spec.kernel2.corr_from_raw(raw, r2_theta)
    return (_bcast(w1) * r1 + _bcast(w2) * r2) / _bcast(s)


def _shareable(spec: MixtureSpec) -> bool:
    if spec.kernel1.raw_kind != spec.kernel2.raw_kind:
        return False
    if spec.kernel1.raw_kind == "sqdist":
        return not spec.anisotropic
    return True


def mixed_gram(spec: MixtureSpec, x: torch.Tensor, params: MixParams,
               predict: bool = False) -> torch.Tensor:
    """R_mix on a point set x (n, d) -> (..., n, n)."""
    th1, th2 = _effective_rates(spec, params, predict)
    if spec.rough == "tied" and spec.kernel1.raw_kind == "sqdist":
        w1, w2, s = mix_weights(params.p)
        d1 = distance.pairwise_sqdist(x, _axis_rates(spec, th1, params))
        scale = _bcast(1.0 + params.theta2)
        return ((_bcast(w1) * torch.exp(-d1)
                 + _bcast(w2) * torch.exp(-scale * d1)) / _bcast(s))
    if _shareable(spec):
        return _mixed_from_shared_raw(spec, spec.kernel1.raw(x), params.p,
                                      th1, th2)
    w1, w2, s = mix_weights(params.p)
    r1 = spec.kernel1.gram(x, _axis_rates(spec, th1, params))
    r2 = spec.kernel2.gram(x, _axis_rates(spec, th2, params))
    return (_bcast(w1) * r1 + _bcast(w2) * r2) / _bcast(s)


def mixed_cross(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                params: MixParams, predict: bool = True,
                normalized: bool = True) -> torch.Tensor:
    """Cross-correlation between x (n, d) and y (m, d) -> (..., n, m);
    `normalized=False` reproduces the reference's two-families bug."""
    th1, th2 = _effective_rates(spec, params, predict)
    w1, w2, s = mix_weights(params.p)
    if _shareable(spec):
        raw = spec.kernel1.raw_cross(x, y)
        r1 = spec.kernel1.corr_from_raw(raw, th1)
        r2 = spec.kernel2.corr_from_raw(raw, th2)
    else:
        r1 = spec.kernel1.cross(x, y, _axis_rates(spec, th1, params))
        r2 = spec.kernel2.cross(x, y, _axis_rates(spec, th2, params))
    out = _bcast(w1) * r1 + _bcast(w2) * r2
    return out / _bcast(s) if normalized else out


def unpack(spec: MixtureSpec, z: torch.Tensor):
    """Unconstrained z (..., n_params) -> (MixParams, log_jacobian).

      iso / 1-D:    z = (psi1, psi2, phi)            theta_i = e^psi_i
      anisotropic:  z = (psi_1..psi_d, phi, zeta)    lambda  = e^zeta
    """
    if spec.anisotropic:
        d = spec.dim
        psis, phi, zeta = z[..., :d], z[..., d], z[..., d + 1]
        theta1, jac1 = transforms.log_to_positive(psis)
        lam, jac_l = transforms.log_to_positive(zeta)
        p, jac_p = transforms.logit_to_unit(phi)
        log_jac = torch.sum(jac1, dim=-1) + jac_l + jac_p
        return MixParams(p=p, theta1=theta1, theta2=lam), log_jac
    psi1, psi2, phi = z[..., 0], z[..., 1], z[..., 2]
    theta1, jac1 = transforms.log_to_positive(psi1)
    theta2, jac2 = transforms.log_to_positive(psi2)
    p, jac_p = transforms.logit_to_unit(phi)
    return MixParams(p=p, theta1=theta1, theta2=theta2), jac1 + jac2 + jac_p


def pack(spec: MixtureSpec, params: MixParams) -> torch.Tensor:
    """Constrained MixParams -> unconstrained z (inverse of unpack)."""
    phi = transforms.unit_to_logit(params.p)
    if spec.anisotropic:
        return torch.cat([torch.log(torch.atleast_1d(params.theta1)),
                          phi[..., None],
                          torch.log(params.theta2)[..., None]], dim=-1)
    return torch.stack([torch.log(params.theta1), torch.log(params.theta2),
                        phi], dim=-1)
