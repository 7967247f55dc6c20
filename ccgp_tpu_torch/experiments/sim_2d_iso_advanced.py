"""2-D isotropic combined GP with empirical-Bayes hyperpriors (port of
`ccgp_tpu/experiments/sim_2d_iso_advanced.py`; reference `2D Codes and
Designs/2D Combined GP Isotropic Advanced.R:930-966`): the reference's
14-point maximin design, its 60 x 4 hyperprior grid scanned with 1728
Halton nodes and tau = 100 at mlegp's sigma^2; the winning (a1, b1, a2,
b2) parameterize the IG priors of the chain.

compat="reference" keeps the reference's lambda-direct training against
theta1 (1 + lambda) prediction (rough="lambda"); the default "fixed"
takes independent rates (rough="free"). The key is split as JAX splits
it, split(key) -> (EB plug-in, study).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ccgp_tpu_torch.eb import choose_hyperpars
from ccgp_tpu_torch.eval.datasets import load_hyperpars_grid, load_maximin_2d
from ccgp_tpu_torch.eval.functions import test_function_2d
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.experiments.sim_2d_iso import lattice
from ccgp_tpu_torch.infer.mle import mlegp_fit
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    func: int = 2
    n_new_axis: int = 25
    alpha: float = 0.05
    n_nodes: int = 1728
    tau: float = 100.0
    compat: str = "fixed"     # 'fixed' (consistent) | 'reference' (quirk)
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=5000,
                                  samp_size=1000, net_samp_size=1000)


def run(cfg: Config = Config(), key=None, dtype=torch.float64,
        device="cuda") -> StudyResult:
    """The study on `device` (the GPU unless device="cpu")."""
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key
    k_eb, k_s = rng.split(key.to(dev))
    x = torch.as_tensor(load_maximin_2d(14), dtype=dtype, device=dev)
    y = test_function_2d(x, cfg.func)
    x_new = lattice(cfg.n_new_axis, dtype, dev)
    y_true = np.asarray(test_function_2d(x_new, cfg.func).cpu())

    rough = "lambda" if cfg.compat == "reference" else "free"
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough=rough)

    # EB: the sigma^2 plug-in first, then the scan of the 60 x 4 grid
    sigma2 = float(mlegp_fit(kernels.sqexp_family(), x, y, k_eb).sigma2)
    choice = choose_hyperpars(spec, x, y, load_hyperpars_grid("2d"), sigma2,
                              n_nodes=cfg.n_nodes, tau=cfg.tau, device=dev)
    a1, b1, a2, b2 = choice.pars.tolist()
    return run_study(spec, x, y, x_new, y_true, k_s, cfg.mcmc,
                     theta1_prior=InverseGamma(a1, b1),
                     theta2_prior=InverseGamma(a2, b2), alpha=cfg.alpha,
                     sigma2=sigma2, single_variant="mlegp", device=dev)
