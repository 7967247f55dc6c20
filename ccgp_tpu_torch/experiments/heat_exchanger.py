"""Heat-exchanger emulator (port of `ccgp_tpu/experiments/heat_exchanger.py`;
reference `Heat Exchanger Emulator/Combined GP Heat Exchanger.R:736-840`):
a 4-D isotropic SE x SE combined GP on the Qian et al. train/test split
(64 and 14 points), priors theta1 ~ IG(7, 3), theta2 ~ IG(3, 28), or with
eb_search the priors chosen by the empirical-Bayes scan of the reference's
624 x 4 grid (1000 Halton nodes, tau = 50) at mlegp's sigma^2.

The key is split as JAX splits it, split(key) -> (EB plug-in, study).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ccgp_tpu_torch.eb import choose_hyperpars
from ccgp_tpu_torch.eval.datasets import load_hyperpars_grid, load_qian
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.infer.mle import mlegp_fit
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    alpha: float = 0.05
    eb_search: bool = False            # off by default, as in the reference
    n_nodes: int = 1000
    tau: float = 50.0
    theta1_pars: tuple = (7.0, 3.0)
    theta2_pars: tuple = (3.0, 28.0)
    mle_ard: bool = True               # mlegp fits per-axis rates
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 2.7, 0.0), n_max=5000,
                                  samp_size=1000, net_samp_size=1000)


def run(cfg: Config = Config(), key=None, dtype=torch.float64,
        device="cuda") -> StudyResult:
    """The study on `device` (the GPU unless device="cpu")."""
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key
    k_eb, k_s = rng.split(key.to(dev))
    q = load_qian()
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)  # noqa: E731
    x, y, x_new = t(q["x_train"]), t(q["y_train"]), t(q["x_test"])

    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=4)
    t1, t2 = cfg.theta1_pars, cfg.theta2_pars
    sigma2 = mle = None
    if cfg.eb_search:
        mle = mlegp_fit(kernels.sqexp_family(), x, y, k_eb)
        sigma2 = float(mle.sigma2)
        choice = choose_hyperpars(spec, x, y, load_hyperpars_grid("heat"),
                                  sigma2, n_nodes=cfg.n_nodes, tau=cfg.tau,
                                  device=dev)
        a1, b1, a2, b2 = choice.pars.tolist()
        t1, t2 = (a1, b1), (a2, b2)

    return run_study(spec, x, y, x_new, q["y_test"], k_s, cfg.mcmc,
                     theta1_prior=InverseGamma(*t1),
                     theta2_prior=InverseGamma(*t2), alpha=cfg.alpha,
                     sigma2=sigma2, mle_ard=cfg.mle_ard,
                     single_variant="mlegp", single_fit=mle, device=dev)
