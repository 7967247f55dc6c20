"""1-D combined GP simulation (port of `ccgp_tpu/experiments/sim_1d.py`;
reference `1D Codes and Designs/1D Combined GP Public.R:1079-1100`):
Matern(nu=5) both components, an 8-point random LHD, functions 1-4,
theta1 ~ IG(3,2), theta2 ~ IG(5,16), Quant against the truth."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ccgp_tpu_torch.design.lhs import random_lhs
from ccgp_tpu_torch.eval.functions import test_function_1d
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
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
    mcmc: MCMCConfig = MCMCConfig(start=(0.0, 1.5, 0.0), n_max=10000,
                                  samp_size=5000, net_samp_size=2500)


def data_1d(cfg, key, dtype, dev, design=None):
    """(x, y, x_new, y_true, k_study) of a 1-D study: the design given
    (cfg.n_train values, reshaped to (n_train, 1)) or else
    random_lhs(split(key)[0]). The key is split either way, so the study
    key does not depend on whether a design is given."""
    k_d, k_s = rng.split(key.to(dev))
    if design is None:
        x = random_lhs(k_d, cfg.n_train, 1, dtype)
    else:
        x = torch.as_tensor(design, dtype=dtype, device=dev).reshape(
            cfg.n_train, 1)
    y = test_function_1d(x[:, 0], cfg.func)
    x_new = torch.as_tensor(np.linspace(0, 1, cfg.n_new)[:, None],
                            dtype=dtype, device=dev)
    y_true = test_function_1d(x_new[:, 0], cfg.func).cpu().numpy()
    return x, y, x_new, y_true, k_s


def run(cfg: Config = Config(), key=None, design=None, dtype=torch.float64,
        device="cuda") -> StudyResult:
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key
    x, y, x_new, y_true, k_s = data_1d(cfg, key, dtype, dev, design)
    fam = kernels.matern_family(cfg.nu)
    return run_study(MixtureSpec(fam, fam, dim=1), x, y, x_new, y_true, k_s,
                     cfg.mcmc, theta1_prior=InverseGamma(3, 2),
                     theta2_prior=InverseGamma(5, 16), alpha=cfg.alpha,
                     quant_vs_truth=True, device=dev)
