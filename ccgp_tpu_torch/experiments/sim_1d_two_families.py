"""1-D combined GP with two kernel families (port of
`ccgp_tpu/experiments/sim_1d_two_families.py`; reference `1D Codes and
Designs/1D Combined GP Two Families Public.R`): Matern(nu) smooth component
+ nonnegative cubic-spline rough component, IG(3,2) / IG(5,16) priors
(`:598`)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.experiments.sim_1d import data_1d
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    func: int = 1
    n_train: int = 8
    nu: float = 5.0
    n_new: int = 50
    alpha: float = 0.05
    # JAX's Config has this flag and its run never reads it: the
    # reference's unnormalized cross-correlation (`:479`) is reachable
    # only through predictive_moments(normalized_cross=False)
    compat_unnormalized_cross: bool = False
    mcmc: MCMCConfig = MCMCConfig(start=(0.0, 1.5, 0.0), n_max=10000,
                                  samp_size=5000, net_samp_size=2500)


def run(cfg: Config = Config(), key=None, design=None, dtype=torch.float64,
        device="cuda") -> StudyResult:
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key
    x, y, x_new, y_true, k_s = data_1d(cfg, key, dtype, dev, design)
    spec = MixtureSpec(kernels.matern_family(cfg.nu),
                       kernels.spline_family(), dim=1)
    return run_study(spec, x, y, x_new, y_true, k_s, cfg.mcmc,
                     theta1_prior=InverseGamma(3, 2),
                     theta2_prior=InverseGamma(5, 16), alpha=cfg.alpha,
                     quant_vs_truth=True,
                     mle_family=kernels.matern_family(cfg.nu), device=dev)
