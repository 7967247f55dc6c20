"""2-D anisotropic combined GP (port of
`ccgp_tpu/experiments/sim_2d_aniso.py`; reference `2D Codes and Designs/2D
Combined GP Anisotropic Public.R`): per-axis SE rates theta = (theta1,
theta2) with the rough component's (1 + lambda) theta; the 4-parameter
posterior (psi1, psi2, phi, zeta); log theta_k ~ N(-1, 1), lambda ~
IG(3, 4) (`:459-462`); the mlegp single-GP baseline and plug-in."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.experiments.sim_2d_iso import data_2d
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    func: int = 2
    n_train: int = 14
    n_new_axis: int = 25
    alpha: float = 0.05
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 1.0, 0.0, 0.0), n_max=5000,
                                  samp_size=1000, net_samp_size=1000)


def run(cfg: Config = Config(), key=None, design=None, dtype=torch.float64,
        device="cuda") -> StudyResult:
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key
    x, y, x_new, y_true, k_s = data_2d(cfg, key, dtype, dev, design)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    return run_study(spec, x, y, x_new, y_true, k_s, cfg.mcmc,
                     theta1_prior=LogNormal(-1.0, 1.0),
                     theta2_prior=InverseGamma(3, 4), alpha=cfg.alpha,
                     single_variant="mlegp", device=dev)
