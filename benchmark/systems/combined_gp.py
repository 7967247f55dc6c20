"""The system under test for configurations with "system": "combined_gp":
`ccgp_tpu_torch`'s two entry points, `fit_combined_gp` and
`predict_combined_gp`, set up from a configuration file. The package is
imported here and in the span wrappers of `harness.trace`, nowhere else
in the harness, and only inside the functions that call it."""
from __future__ import annotations

from typing import NamedTuple

import torch


# the traced run's spans: (module, attribute) -> span name
SPANS = {
    ("ccgp_tpu_torch.models.combined_gp", "kriging_mle"): "plugin",
    ("ccgp_tpu_torch.models.combined_gp", "kriging_mle_grid"): "plugin",
    ("ccgp_tpu_torch.models.combined_gp", "metropolis"): "metropolis",
    ("ccgp_tpu_torch.infer.metropolis", "laplace"): "laplace",
    ("ccgp_tpu_torch.models.combined_gp", "predictive_moments"): "moments",
    ("ccgp_tpu_torch.models.combined_gp", "posterior_predict"): "intervals",
}


class FitOut(NamedTuple):
    """What the correctness check reads of a fit, kept off the factor
    cache: the request's key, the plug-in, the Laplace fit the chain
    started from, every recorded draw with its log-posterior, the chain's
    counters, and the retained draws with the intercepts predict uses."""

    key: torch.Tensor           # the request's fit key
    theta: torch.Tensor         # plug-in rate
    beta: torch.Tensor
    sigma2: torch.Tensor
    mode: torch.Tensor          # Laplace mode: the chain's start
    cov: torch.Tensor           # Laplace covariance
    chain: torch.Tensor         # (n_recorded, dim) recorded draws
    chain_lp: torch.Tensor      # (n_recorded,) their log-posteriors
    n_rounds: int
    n_proposals: int
    converged: bool
    zs: torch.Tensor            # (net, dim) retained draws
    betas: torch.Tensor         # (net,) their intercepts in the factors


class PredOut(NamedTuple):
    mean: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    draw_mean: torch.Tensor
    draw_var: torch.Tensor


def _prior(p: dict):
    from ccgp_tpu_torch.models import priors

    if p["kind"] == "inverse_gamma":
        return priors.InverseGamma(p["a"], p["b"])
    if p["kind"] == "lognormal":
        return priors.LogNormal(p["mu"], p["sigma"])
    raise ValueError(f"unknown prior {p['kind']!r}")


class System:
    def __init__(self, cfg: dict, device: str):
        from ccgp_tpu_torch.models.combination import MixtureSpec
        from ccgp_tpu_torch.models.combined_gp import MCMCConfig
        from ccgp_tpu_torch.ops import kernels

        self.cfg, self.device = cfg, device
        self.dtype = getattr(torch, cfg["dtype"])
        family = getattr(kernels, f"{cfg['kernel']}_family")
        self.spec = MixtureSpec(family(), family(), dim=cfg["dim"],
                                rough=cfg["rough"],
                                anisotropic=cfg["anisotropic"])
        self.mcmc = MCMCConfig(
            start=tuple(float(v) for v in cfg["start"]),
            n_max=cfg["n_max"], samp_size=cfg["samp_size"],
            net_samp_size=cfg["net_samp_size"],
            batch_size=cfg["batch_size"], alpha_geweke=cfg["alpha_geweke"],
            speculative=cfg["speculative"])
        self.priors = dict(theta1_prior=_prior(cfg["theta1_prior"]),
                           theta2_prior=_prior(cfg["theta2_prior"]))

    def fit(self, x, y, key):
        from ccgp_tpu_torch.models.combined_gp import fit_combined_gp

        return fit_combined_gp(self.spec, x, y, key, mcmc=self.mcmc,
                               jitter=self.cfg["jitter"],
                               mle_method=self.cfg["plugin"],
                               device=self.device, **self.priors)

    def predict(self, fit, x, x_new, key):
        from ccgp_tpu_torch.models.combined_gp import predict_combined_gp

        return predict_combined_gp(self.spec, fit, x, x_new, key,
                                   alpha=self.cfg["alpha"],
                                   device=self.device)

    def fit_out(self, fit, key) -> FitOut:
        mc = fit.mcmc
        n = int(mc.n_recorded)
        return FitOut(key=key, theta=fit.mle.theta, beta=fit.mle.beta,
                      sigma2=fit.sigma2, mode=mc.laplace.mode,
                      cov=mc.laplace.cov, chain=mc.samples[:n],
                      chain_lp=mc.logposts[:n],
                      n_rounds=int(mc.n_rounds if mc.n_rounds is not None
                                   else mc.n_proposals),
                      n_proposals=int(mc.n_proposals),
                      converged=bool(mc.converged), zs=fit.zs,
                      betas=fit.cache.beta)

    @staticmethod
    def pred_out(pred) -> PredOut:
        return PredOut(pred.mean, pred.lower, pred.upper, pred.draw_mean,
                       pred.draw_var)

    @staticmethod
    def failed(fit, pred) -> bool:
        """Unusable: an unhealthy chain or a non-finite prediction."""
        if fit is not None and not fit.chain_ok:
            return True
        return not bool(torch.isfinite(pred.mean).all()
                        & torch.isfinite(pred.lower).all()
                        & torch.isfinite(pred.upper).all())

    @staticmethod
    def chain(fit) -> dict:
        mc = fit.mcmc
        return {"n_rounds": int(mc.n_rounds or 0),
                "n_proposals": int(mc.n_proposals),
                "n_recorded": int(mc.n_recorded)}

    @staticmethod
    def load():
        """Build or load the package's kernels (set-up)."""
        from ccgp_tpu_torch.ops import _build

        _build.library()

    @staticmethod
    def launches() -> dict:
        """The kernel wrappers' launch counters the readers use."""
        from ccgp_tpu_torch.ops import chol_smallk

        return {"k1": chol_smallk.fused_mix_mh_rounds.launches}
