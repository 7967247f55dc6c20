"""Batch-sequential maximum-entropy design study (port of
`ccgp_tpu/experiments/batch_me_design.py`; reference `Batch Sequential ME
Designs/Batch Sequential ME Design.R:963-1108`, paper section 7):

  1. the first batch: the shipped 14-point initial ME design for the prior
     means (p = 0.5, theta1 = 1, theta2 = 4), or with regenerate_first
     that design found by `me_design` (needs no data file);
  2. observe y, fit the combined GP on the first batch;
  3. plug in the posterior mean (or the MAP of the retained draws) and
     find a 7-point second batch by augmented entropy;
  4. optionally the k-medoids variant: one 7-point subdesign per
     posterior draw, the cloud clustered to 7 medoids;
  5. refit on all 21 points and compare the three models on the 25 x 25
     lattice of [-1, 1]^2.

The key is split as JAX splits it, split(key, 5) -> (first batch, fit,
second batch, k-medoids, study).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ccgp_tpu_torch.design import batch_me_design, kmedoids, me_design
from ccgp_tpu_torch.eval.datasets import load_initial_me_design
from ccgp_tpu_torch.eval.functions import test_function_batch
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.models.combination import MixParams, MixtureSpec, unpack
from ccgp_tpu_torch.models.combined_gp import (
    CombinedGPFit, MCMCConfig, fit_combined_gp)
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    func: int = 1
    n_first: int = 14
    n_second: int = 7
    n_starts: int = 25
    plug_in: str = "posterior_mean"    # 'posterior_mean' | 'map'
    regenerate_first: bool = False
    kmedoids_draws: int = 0            # > 0: the k-medoids variant
    n_new_axis: int = 25
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=5000,
                                  samp_size=1000, net_samp_size=1000)


class BatchDesignResult(NamedTuple):
    d_first: np.ndarray
    d_second: np.ndarray
    plug_in_params: MixParams
    log_entropy: float
    study: Optional[StudyResult]
    d_second_kmedoids: Optional[np.ndarray]
    fit: Optional[CombinedGPFit] = None   # the first batch's fit


def run(cfg: Config = Config(), key=None, dtype=torch.float64,
        device="cuda", refit: bool = True) -> BatchDesignResult:
    """The study on `device` (the GPU unless device="cpu")."""
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key.to(dev)
    k_first, k_fit, k_design, k_med, k_study = rng.split(key, 5)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)  # noqa: E731
    priors = dict(theta1_prior=InverseGamma(3, 2),
                  theta2_prior=InverseGamma(5, 16))

    if cfg.regenerate_first:
        first = me_design(spec, MixParams(p=t(0.5), theta1=t(1.0),
                                          theta2=t(4.0)),
                          cfg.n_first, 2, k_first, n_starts=cfg.n_starts)
        d_first = first.design.cpu().numpy()
    else:
        d_first = load_initial_me_design()
    x1 = t(d_first)
    fit = fit_combined_gp(spec, x1, test_function_batch(x1, cfg.func), k_fit,
                          mcmc=cfg.mcmc, device=dev, **priors)

    if cfg.plug_in == "map":
        zs, _, lps = fit.mcmc.retained(cfg.mcmc.samp_size)
        plug, _ = unpack(spec, zs[torch.argmax(lps)])
    else:
        plug = MixParams(p=fit.params.p.mean(),
                         theta1=fit.params.theta1.mean(),
                         theta2=fit.params.theta2.mean())

    second = batch_me_design(spec, plug, x1, cfg.n_second, k_design,
                             n_starts=cfg.n_starts)
    d_second = second.design.cpu().numpy()

    d_km = None
    if cfg.kmedoids_draws > 0:
        # one subdesign per posterior draw, then k-medoids over the cloud
        m = min(cfg.kmedoids_draws, fit.zs.shape[0])
        subs = [batch_me_design(spec, unpack(spec, z)[0], x1, cfg.n_second,
                                kk, n_starts=4, maxiter=80).design
                for z, kk in zip(fit.zs[:m], rng.split(k_med, m))]
        cloud = torch.stack(subs).reshape(-1, 2)
        d_km = kmedoids(cloud, cfg.n_second, k_med).medoids.cpu().numpy()

    study = None
    if refit:
        x_all = torch.cat([x1, t(d_second)])
        u = np.linspace(-1, 1, cfg.n_new_axis)
        x_new = t(np.stack(np.meshgrid(u, u), -1).reshape(-1, 2))
        y_true = test_function_batch(x_new, cfg.func).cpu().numpy()
        study = run_study(spec, x_all, test_function_batch(x_all, cfg.func),
                          x_new, y_true, k_study, cfg.mcmc,
                          single_variant="mlegp", device=dev, **priors)

    return BatchDesignResult(d_first=d_first, d_second=d_second,
                             plug_in_params=plug,
                             log_entropy=float(second.log_entropy),
                             study=study, d_second_kmedoids=d_km, fit=fit)
