"""CombinedGP: the end-to-end fit -> predict pipeline (port of
`ccgp_tpu/models/combined_gp.py`).

  1. plug-in sigma^2 from an ordinary-kriging profile-ML fit (multistart
     BFGS by default, or the batched grid),
  2. Laplace-seeded Metropolis with Geweke stopping,
  3. the per-draw factor cache: decoded from the sampler's stash where the
     fused rounds kernel wrote one, else rebuilt by `build_factors` (or,
     with draw_chunk, a lazy cache that predict fills draw_chunk draws at
     a time through the lanes factor kernel),
  4. posterior-predictive moments and MC intervals.

Routing of the sampler, JAX's (`combined_gp.py:145-209`) without its test
of the backend:
  * speculative K > 1, SE/SE, record="accepted" and MH_ROUNDS_CHUNKING:
    the chunked driver; inside `dispatch_ok(n, K)` its rounds run in the
    fused rounds kernel, which also stashes the factors (the CPU takes the
    kernel's plain twin);
  * every other speculative fit: one round per iteration through
    `make_mh_round` (SE/SE with n <= 256, K <= 16: the fused round kernel;
    else the batched log-posterior, whose K Grams go to the small-K
    kernel), and the cache is rebuilt;
  * speculative <= 1: the K = 1 body.
whiten=True (the cancellation-free quadratic, `models/likelihood.py`)
keeps the chunked driver but takes none of the fused kernels and no
stash, as JAX turns them off (`ccgp_tpu/models/combined_gp.py:171-172`):
the rounds loop over the whitened batched log-posterior and
`build_factors` rebuilds the cache (the lanes factor kernel K4 from 64
draws on).
Both entry points run on the GPU unless device="cpu" is asked for, and
move their inputs there. Each call is one request record of the tracer
(`utils.trace`): the span `fit` or `predict`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ccgp_tpu_torch.infer.metropolis import (
    ROUNDS_PER_CALL_WARM, MetropolisResult, metropolis)
from ccgp_tpu_torch.infer.mle import KrigingMLE, kriging_mle, kriging_mle_grid
from ccgp_tpu_torch.models.combination import MixParams, MixtureSpec, unpack
from ccgp_tpu_torch.models.likelihood import (
    is_se_mix, make_logpost, make_mh_round, make_mh_rounds)
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import rng
from ccgp_tpu_torch.ops.chol_smallk import dispatch_ok
from ccgp_tpu_torch.ops.kernels import KernelFamily
from ccgp_tpu_torch.predict.factors import (
    FactorCache, build_factors, decode_stash)
from ccgp_tpu_torch.predict.posterior import (
    PosteriorPrediction, posterior_predict, predictive_moments,
    predictive_moments_lazy)
from ccgp_tpu_torch.utils import trace
from ccgp_tpu_torch.utils.device import move, resolve

# routes SE/SE speculative sampling through the chunked driver (the fused
# rounds kernel with the factor stash); False takes the one-round body with
# the fused round kernel instead. The two run the same chain.
MH_ROUNDS_CHUNKING = True

# device-memory budget of the sampler's stash buffer; a chain that records
# past a capped buffer rebuilds its factor cache instead
_STASH_BUDGET_BYTES = 2 << 30


@dataclass(frozen=True)
class MCMCConfig:
    """Knobs of the reference's `Metro` runs (defaults = 2-D scripts)."""

    start: tuple = (1.0, 1.0, 0.0)
    n_max: int = 5000
    samp_size: int = 1000
    net_samp_size: int = 1000
    batch_size: int = 20
    alpha_geweke: float = 0.5
    record: str = "accepted"
    max_proposals: Optional[int] = None
    speculative: int = 0


class CombinedGPFit(NamedTuple):
    sigma2: torch.Tensor
    mle: Optional[KrigingMLE]
    mcmc: Optional[MetropolisResult]
    cache: FactorCache          # factors for the net retained draws
    zs: torch.Tensor            # (net, n_params) retained draws
    params: MixParams           # batched constrained draws
    chain_ok: Optional[bool] = None
    y: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None


@trace.span("fit")
def fit_combined_gp(
    spec: MixtureSpec,
    x: torch.Tensor,
    y: torch.Tensor,
    key: torch.Tensor,
    mcmc: MCMCConfig = MCMCConfig(),
    theta1_prior=InverseGamma(3, 2),
    theta2_prior=InverseGamma(5, 16),
    p_prior=None,
    sigma2=None,
    mle_family: Optional[KernelFamily] = None,
    mle_ard: bool = False,
    jitter: float = 0.0,
    mle_method: str = "bfgs",
    whiten: bool = False,
    draw_chunk: Optional[int] = None,
    device="cuda",
) -> CombinedGPFit:
    """Fit the combined GP (see the module docstring for the routing).
    key is an int64 (2,) threefry key (`ops.rng.PRNGKey`); x, y and key
    are moved to `device`. sigma2=None fits the plug-in by
    mle_method="bfgs" (`kriging_mle`, keyed by the first half of key) or
    "grid" (`kriging_mle_grid`, scalar rate only).

    draw_chunk: skip the (net, n, n) factor cache and return a LAZY one
    (empty factor arrays, the marker predict dispatches on); the sampler
    still stashes as usual, so the chain is the same. The fit keeps y and
    jitter, so `predict_combined_gp` rebuilds the factors draw_chunk
    draws at a time by itself."""
    dev = resolve(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, dtype=x.dtype, device=dev)
    k_mle, k_mcmc = rng.split(key.to(dev), 2)
    family = mle_family or spec.kernel1
    if mle_method == "grid":
        if mle_ard:
            raise ValueError("mle_method='grid' supports scalar rates only")
        mle = kriging_mle_grid(family, x, y, jitter=jitter)
    else:
        mle = kriging_mle(family, x, y, k_mle, ard=mle_ard, jitter=jitter)
    s2 = mle.sigma2 if sigma2 is None else torch.as_tensor(
        sigma2, dtype=x.dtype, device=x.device)
    priors = dict(theta1_prior=theta1_prior, theta2_prior=theta2_prior,
                  p_prior=p_prior, whiten=whiten)
    logpost = make_logpost(spec, x, y, s2, jitter=jitter, **priors)

    n_train = x.shape[-2]
    K = mcmc.speculative
    round_fn = rounds_fn = None
    use_stash, stash_cap = False, None
    if K and K > 1:
        if (MH_ROUNDS_CHUNKING and is_se_mix(spec)
                and mcmc.record == "accepted"):
            use_stash = not whiten and dispatch_ok(n_train, K)
            if use_stash:
                row_bytes = (n_train + 2) * n_train * x.element_size()
                slack = ROUNDS_PER_CALL_WARM + 1
                cap_allowed = _STASH_BUDGET_BYTES // row_bytes
                if cap_allowed >= mcmc.n_max + slack:
                    stash_cap = None
                elif cap_allowed >= mcmc.samp_size + slack:
                    stash_cap = int(cap_allowed)
                else:
                    use_stash = False
            rounds_fn = make_mh_rounds(spec, x, y, s2, jitter=jitter,
                                       stash=use_stash, **priors)
        else:
            round_fn = make_mh_round(spec, x, y, s2, jitter=jitter, **priors)
    res = metropolis(logpost, torch.tensor(mcmc.start, dtype=x.dtype,
                                           device=x.device), k_mcmc,
                     n_max=mcmc.n_max, samp_size=mcmc.samp_size,
                     batch_size=mcmc.batch_size,
                     alpha_geweke=mcmc.alpha_geweke, record=mcmc.record,
                     max_proposals=mcmc.max_proposals, speculative=K,
                     mh_round=round_fn, mh_rounds=rounds_fn,
                     stash_rows=n_train + 2 if use_stash else None,
                     stash_lanes=n_train, stash_cap=stash_cap)

    zs_all, betas_all, _ = res.retained(mcmc.samp_size)
    zs = zs_all[mcmc.samp_size - mcmc.net_samp_size:]
    betas = betas_all[mcmc.samp_size - mcmc.net_samp_size:]
    params, _ = unpack(spec, zs)
    decodable = res.factors is not None and (
        stash_cap is None
        or (res.factors_ok and res.n_recorded <= res.factors.shape[0]))
    if draw_chunk is not None:
        empty = torch.zeros((0, n_train), dtype=x.dtype, device=x.device)
        cache = FactorCache(chol=torch.zeros((0, n_train, n_train),
                                             dtype=x.dtype, device=x.device),
                            a=empty, u=empty, beta=betas, params=params)
    elif decodable:
        hi = min(max(res.n_recorded - 1, 0), res.factors.shape[0] - 1)
        idx = torch.clamp(res.n_recorded - mcmc.net_samp_size
                          + torch.arange(mcmc.net_samp_size,
                                         device=x.device), 0, hi)
        chol, wy, wo = decode_stash(res.factors[idx], n_train)
        cache = FactorCache(chol=chol, a=wy - betas[:, None] * wo, u=wo,
                            beta=betas, params=params)
    else:
        cache = build_factors(spec, x, y, zs, betas, jitter=jitter)
    return CombinedGPFit(sigma2=s2, mle=mle, mcmc=res, cache=cache, zs=zs,
                         params=params,
                         chain_ok=res.chain_ok(mcmc.samp_size), y=y,
                         jitter=torch.tensor(jitter, dtype=x.dtype,
                                             device=x.device))


@trace.span("predict")
def predict_combined_gp(
    spec: MixtureSpec,
    fit: CombinedGPFit,
    x: torch.Tensor,
    x_new: torch.Tensor,
    key: torch.Tensor,
    alpha: float = 0.05,
    quant_ref: Optional[torch.Tensor] = None,
    var_scale: str = "sigma2",
    normalized_cross: bool = True,
    drop_negative_var: bool = True,
    y: Optional[torch.Tensor] = None,
    jitter=0.0,
    draw_chunk: int = 64,
    device="cuda",
) -> PosteriorPrediction:
    """Posterior-predictive prediction from a CombinedGPFit; the fit, x,
    x_new and key are moved to `device`.

    A fit built with `fit_combined_gp(..., draw_chunk=...)` carries a lazy
    factor cache: its moments are computed `draw_chunk` draws at a time
    (`predictive_moments_lazy`) with the y and jitter stored on the fit;
    y= and jitter= serve only fits that do not store them."""
    dev = resolve(device)
    fit = move(fit, dev)
    x = torch.as_tensor(x, device=dev)
    x_new = torch.as_tensor(x_new, dtype=x.dtype, device=dev)
    key = key.to(dev)
    if fit.cache.chol.shape[0] == 0 and fit.zs.shape[0] > 0:
        y_train = fit.y if fit.y is not None else y
        if y_train is None:
            raise ValueError(
                "fit carries a lazy factor cache (fit_combined_gp(..., "
                "draw_chunk=...)) but no stored y: pass y= and the fit's "
                "jitter= to predict_combined_gp")
        dm, dv = predictive_moments_lazy(
            spec, x, torch.as_tensor(y_train, dtype=x.dtype, device=dev),
            x_new, fit.zs, fit.cache.beta, fit.sigma2,
            jitter=fit.jitter if fit.jitter is not None else jitter,
            draw_chunk=draw_chunk, var_scale=var_scale,
            normalized_cross=normalized_cross)
    else:
        dm, dv = predictive_moments(spec, fit.cache, x, x_new, fit.sigma2,
                                    var_scale=var_scale,
                                    normalized_cross=normalized_cross)
    return posterior_predict(key, dm, dv, alpha=alpha, quant_ref=quant_ref,
                             drop_negative_var=drop_negative_var)
