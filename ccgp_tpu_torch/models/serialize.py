"""Fit checkpoint and resume (port of `ccgp_tpu/models/serialize.py`).

A fitted combined GP (the posterior draws, the factor cache, the plug-in
MLE, the Laplace proposal) round-trips through one `.npz` under the JAX
package's keys, so a file either package writes loads in the other. The
port's sampler also reports its speculative round count, which JAX's
`save_fit` does not keep; it goes under a key of its own (`mcmc_n_rounds`)
that JAX's loader ignores, and a file without it loads with None, as
JAX's loader leaves the fields it does not read. The stash buffer, like
JAX's, is not saved: the factor cache holds the retained draws' factors.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ccgp_tpu_torch.infer.laplace import LaplaceFit
from ccgp_tpu_torch.infer.metropolis import MetropolisResult
from ccgp_tpu_torch.infer.mle import KrigingMLE
from ccgp_tpu_torch.models.combination import MixParams
from ccgp_tpu_torch.models.combined_gp import CombinedGPFit
from ccgp_tpu_torch.predict.factors import FactorCache
from ccgp_tpu_torch.utils.device import resolve


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_fit(path: str | Path, fit: CombinedGPFit) -> None:
    mc = fit.mcmc
    flat = {
        "sigma2": fit.sigma2,
        "mle_beta": fit.mle.beta, "mle_sigma2": fit.mle.sigma2,
        "mle_theta": fit.mle.theta, "mle_nll": fit.mle.nll,
        "mle_chol": fit.mle.chol,
        "mcmc_samples": mc.samples, "mcmc_betas": mc.betas,
        "mcmc_logposts": mc.logposts,
        "mcmc_n_recorded": mc.n_recorded,
        "mcmc_n_proposals": mc.n_proposals,
        "mcmc_n_accepted": mc.n_accepted,
        "mcmc_pvalue": mc.pvalue, "mcmc_converged": mc.converged,
        "laplace_mode": mc.laplace.mode,
        "laplace_cov": mc.laplace.cov,
        "laplace_logpost": mc.laplace.logpost,
        "cache_chol": fit.cache.chol, "cache_a": fit.cache.a,
        "cache_u": fit.cache.u, "cache_beta": fit.cache.beta,
        "params_p": fit.params.p, "params_theta1": fit.params.theta1,
        "params_theta2": fit.params.theta2,
        "zs": fit.zs,
    }
    optional = {"chain_ok": fit.chain_ok, "y": fit.y, "jitter": fit.jitter,
                "mcmc_n_rounds": mc.n_rounds}
    flat.update({k: v for k, v in optional.items() if v is not None})
    np.savez_compressed(Path(path), **{k: _np(v) for k, v in flat.items()})


def load_fit(path: str | Path, device="cuda") -> CombinedGPFit:
    """The fit saved at `path`, its tensors on `device` (the GPU unless
    device="cpu"); the chain's counters and flags as Python scalars, as
    the port's sampler returns them."""
    dev = resolve(device)
    z = np.load(Path(path))
    j = lambda k: torch.as_tensor(z[k], device=dev)  # noqa: E731
    mle = KrigingMLE(beta=j("mle_beta"), sigma2=j("mle_sigma2"),
                     theta=j("mle_theta"), nll=j("mle_nll"),
                     chol=j("mle_chol"))
    lap = LaplaceFit(mode=j("laplace_mode"), cov=j("laplace_cov"),
                     logpost=j("laplace_logpost"))
    mcmc = MetropolisResult(
        samples=j("mcmc_samples"), betas=j("mcmc_betas"),
        logposts=j("mcmc_logposts"), n_recorded=int(z["mcmc_n_recorded"]),
        n_proposals=int(z["mcmc_n_proposals"]),
        n_accepted=int(z["mcmc_n_accepted"]),
        pvalue=float(z["mcmc_pvalue"]), converged=bool(z["mcmc_converged"]),
        laplace=lap,
        n_rounds=int(z["mcmc_n_rounds"]) if "mcmc_n_rounds" in z else None)
    params = MixParams(p=j("params_p"), theta1=j("params_theta1"),
                       theta2=j("params_theta2"))
    cache = FactorCache(chol=j("cache_chol"), a=j("cache_a"),
                        u=j("cache_u"), beta=j("cache_beta"), params=params)
    return CombinedGPFit(
        sigma2=j("sigma2"), mle=mle, mcmc=mcmc, cache=cache, zs=j("zs"),
        params=params,
        chain_ok=bool(z["chain_ok"]) if "chain_ok" in z else None,
        y=j("y") if "y" in z else None,
        jitter=j("jitter") if "jitter" in z else None)
