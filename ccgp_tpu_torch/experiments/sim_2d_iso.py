"""2-D isotropic combined GP simulation (port of
`ccgp_tpu/experiments/sim_2d_iso.py`; reference `2D Codes and Designs/2D
Combined GP Isotropic Public.R:840-868`): SE kernels, a 14-point maximin
LHS, a 25 x 25 prediction lattice, functions 1-5, the
mlegp single-GP baseline and plug-in."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ccgp_tpu_torch.design.lhs import maximin_lhs
from ccgp_tpu_torch.eval.functions import test_function_2d
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    func: int = 2
    n_train: int = 14
    n_new_axis: int = 25
    alpha: float = 0.05
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=5000,
                                  samp_size=1000, net_samp_size=1000)


def lattice(n: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The n x n lattice on [0, 1]^2, (n^2, 2), x varying fastest."""
    u = np.linspace(0, 1, n)
    return torch.as_tensor(np.stack(np.meshgrid(u, u), -1).reshape(-1, 2),
                           dtype=dtype, device=device)


def data_2d(cfg, key, dtype, dev, design=None):
    """(x, y, x_new, y_true, k_study) of a 2-D study: the design given (n,
    2) or else maximin_lhs(split(key)[0]). The key is split either way,
    so the study key does not depend on whether a design is given."""
    k_d, k_s = rng.split(key.to(dev))
    if design is None:
        x = maximin_lhs(k_d, cfg.n_train, 2, dtype=dtype)
    else:
        x = torch.as_tensor(design, dtype=dtype, device=dev)
    x_new = lattice(cfg.n_new_axis, dtype, dev)
    y_true = test_function_2d(x_new, cfg.func).cpu().numpy()
    return x, test_function_2d(x, cfg.func), x_new, y_true, k_s


def run(cfg: Config = Config(), key=None, design=None, dtype=torch.float64,
        device="cuda") -> StudyResult:
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key
    x, y, x_new, y_true, k_s = data_2d(cfg, key, dtype, dev, design)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    return run_study(spec, x, y, x_new, y_true, k_s, cfg.mcmc,
                     theta1_prior=InverseGamma(3, 2),
                     theta2_prior=InverseGamma(5, 16), alpha=cfg.alpha,
                     single_variant="mlegp", device=dev)
