"""Convert the JAX package's state, given as numpy arrays, into the port's.

Nothing here imports JAX: the caller flattens its JAX objects to numpy
(`np.asarray`) first. Keys become int64 (2,) tensors holding the two
uint32 words, the port's key layout. Every function puts its tensors on
the GPU unless device="cpu" is asked for (see `utils.device`).
"""
from __future__ import annotations

import numpy as np
import torch

from ccgp_tpu_torch.infer.laplace import LaplaceFit
from ccgp_tpu_torch.infer.metropolis import MetropolisResult
from ccgp_tpu_torch.infer.mle import KrigingMLE
from ccgp_tpu_torch.models.combination import MixParams
from ccgp_tpu_torch.models.combined_gp import CombinedGPFit
from ccgp_tpu_torch.models.composite_gp import CGPFit
from ccgp_tpu_torch.predict.factors import FactorCache
from ccgp_tpu_torch.utils.device import resolve


def _t(a, dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if dtype is None and arr.dtype.kind == "f":
        dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
    return torch.as_tensor(np.array(arr), dtype=dtype, device=device)


def key_from_numpy(key, device="cuda") -> torch.Tensor:
    """A raw threefry key (2,) uint32 -> int64 (2,)."""
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"expected a raw (2,) threefry key, got {k.shape}")
    return torch.as_tensor(k.astype(np.int64), device=resolve(device))


def laplace_from_numpy(mode, cov, logpost, dtype=None,
                       device="cuda") -> LaplaceFit:
    """A `LaplaceFit` from its three arrays."""
    device = resolve(device)
    return LaplaceFit(mode=_t(mode, dtype, device), cov=_t(cov, dtype, device),
                      logpost=_t(logpost, dtype, device))


def mle_from_numpy(beta, sigma2, theta, nll, chol, dtype=None,
                   device="cuda") -> KrigingMLE:
    """A `KrigingMLE` (of `kriging_mle` or `kriging_mle_grid`) from its
    five arrays."""
    device = resolve(device)
    return KrigingMLE(*(_t(v, dtype, device)
                        for v in (beta, sigma2, theta, nll, chol)))


def cgp_from_numpy(*, dtype=None, device="cuda", **arrays) -> CGPFit:
    """A predict-ready `CGPFit` (the composite GP) from its 15 arrays, by
    field name (`CGPFit._fields`)."""
    device = resolve(device)
    missing = set(CGPFit._fields) - set(arrays)
    if missing or len(arrays) != len(CGPFit._fields):
        raise ValueError(f"CGPFit needs exactly the fields {CGPFit._fields}")
    return CGPFit(**{f: _t(arrays[f], dtype, device)
                     for f in CGPFit._fields})


def mcmc_from_numpy(*, samples, betas, logposts, n_recorded, n_proposals,
                    n_accepted, pvalue, converged, laplace: LaplaceFit,
                    n_rounds=None, dtype=None,
                    device="cuda") -> MetropolisResult:
    """A `MetropolisResult` of a one-round chain (the K = 1, `body_spec`
    and `body_mh` routes, which stash no factors) from its arrays; the
    counters become Python ints and flags as the port keeps them."""
    device = resolve(device)
    c = lambda v: _t(v, dtype, device)  # noqa: E731
    return MetropolisResult(
        samples=c(samples), betas=c(betas), logposts=c(logposts),
        n_recorded=int(n_recorded), n_proposals=int(n_proposals),
        n_accepted=int(n_accepted), pvalue=float(pvalue),
        converged=bool(converged), laplace=laplace,
        n_rounds=None if n_rounds is None else int(n_rounds))


def fit_from_numpy(*, sigma2, zs, p, theta1, theta2, chol, a, u, beta,
                   y=None, jitter=None, mle=None, mcmc=None, chain_ok=None,
                   dtype=None, device="cuda") -> CombinedGPFit:
    """A predict-ready `CombinedGPFit` from a JAX fit's arrays: sigma2, the
    retained draws zs, their constrained params (p, theta1, theta2), the
    factor cache (chol, a, u, beta), and optionally y, jitter, the
    plug-in (`mle_from_numpy`), the chain (`mcmc_from_numpy`) and
    chain_ok."""
    device = resolve(device)
    c = lambda v: _t(v, dtype, device)  # noqa: E731
    params = MixParams(p=c(p), theta1=c(theta1), theta2=c(theta2))
    cache = FactorCache(chol=c(chol), a=c(a), u=c(u), beta=c(beta),
                        params=params)
    return CombinedGPFit(sigma2=c(sigma2), mle=mle, mcmc=mcmc, cache=cache,
                         zs=c(zs), params=params,
                         chain_ok=None if chain_ok is None else bool(chain_ok),
                         y=None if y is None else c(y),
                         jitter=None if jitter is None else c(jitter))
