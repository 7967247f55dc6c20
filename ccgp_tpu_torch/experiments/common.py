"""The study runner (port of `ccgp_tpu/experiments/common.py`): fit the
combined GP (plug-in sigma^2 -> Metropolis -> posterior predictive), the
single GP (ordinary kriging with t-intervals) and the composite GP on the
same data, then the RMSPE / coverage / calibration table, as the
reference's `compare.GP` + `Comparison.Summary` (`1D Codes and Designs/1D
Combined GP Public.R:854-903`).

The key is split in JAX's order, `split(key, 4)` -> (fit, predict,
composite GP, single GP), so a key gives the JAX package's study.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ccgp_tpu_torch.eval.compare import (
    ComparisonSummary, ModelPrediction, comparison_summary)
from ccgp_tpu_torch.infer.diagnostics import effective_sample_size
from ccgp_tpu_torch.infer.mle import KrigingMLE, kriging_mle, mlegp_fit
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import (
    CombinedGPFit, MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.composite_gp import CGPFit, cgp_fit, cgp_predict
from ccgp_tpu_torch.models.kriging import kriging_predict
from ccgp_tpu_torch.ops import rng
from ccgp_tpu_torch.ops.kernels import KernelFamily
from ccgp_tpu_torch.utils import trace
from ccgp_tpu_torch.utils.device import move, resolve


class StudyResult(NamedTuple):
    summary: ComparisonSummary
    fit: CombinedGPFit
    predictions: dict     # model name -> ModelPrediction (numpy)
    y_true: np.ndarray
    # min-over-parameters ESS of the retained window: Geweke convergence
    # alone can hide a random-walk chain that mixes badly
    min_ess: float = float("nan")
    # the fits the baselines predicted from: the single GP's (with
    # single_variant="mlegp" also the sigma^2 plug-in) and the composite
    # GP's; None where the study ran no such model
    single_fit: Optional[KrigingMLE] = None
    cgp_fit: Optional[CGPFit] = None


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@trace.span("study")
def run_study(
    spec: MixtureSpec,
    x,
    y,
    x_new,
    y_true: np.ndarray,
    key: torch.Tensor,
    mcmc: MCMCConfig,
    theta1_prior,
    theta2_prior,
    alpha: float = 0.05,
    quant_vs_truth: bool = False,     # the 1-D reference's Quant vs y_true
    sigma2=None,
    mle_family: Optional[KernelFamily] = None,
    mle_ard: bool = False,
    run_cgp: bool = True,
    run_single: bool = True,
    cgp_candidates: int = 505,
    jitter: float = 0.0,
    on_unconverged: str = "warn",     # 'warn' | 'raise' | 'ignore'
    single_variant: str = "reference",  # 'reference' (1-D) | 'mlegp' (>= 2-D)
    single_fit=None,                  # a precomputed mlegp / kriging fit
    device="cuda",
) -> StudyResult:
    """The study on `device` (the GPU unless device="cpu"): x, y, x_new and
    the key are moved there. The combined GP and the single GP (unless
    run_single=False) are fitted with `jitter`, the composite GP with
    `cgp_candidates` LHD candidates unless run_cgp=False. An unhealthy
    chain warns (RuntimeWarning), raises (RuntimeError) or passes, as
    on_unconverged is "warn", "raise" or "ignore"; any other value raises
    ValueError before anything runs.

    With single_variant="mlegp" one `mlegp_fit` gives both the sigma^2
    plug-in and the single-GP baseline, as the >= 2-D scripts take both
    from one mlegp fit; `single_fit` (a `KrigingMLE`) replaces that fit,
    and sigma2 replaces its plug-in: the fit is skipped when sigma2 is
    given and run_single=False. Else the combined GP takes sigma2, or its
    own plug-in when it is None, and the baseline is `single_fit` or
    `kriging_mle`'s (ARD with mle_ard=True).

    A study is one tracer record, the span `study`: the fits' and
    predictions' spans nest under it, the single GP's prediction as
    `single`."""
    if on_unconverged not in ("warn", "raise", "ignore"):
        raise ValueError(on_unconverged)
    dev = resolve(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, dtype=x.dtype, device=dev)
    x_new = torch.as_tensor(x_new, dtype=x.dtype, device=dev)
    k_fit, k_pred, k_cgp, k_single = rng.split(key.to(dev), 4)
    fam = mle_family or spec.kernel1

    mlegp = single_variant == "mlegp"
    kfit = move(single_fit, dev)
    if mlegp and kfit is None and (sigma2 is None or run_single):
        kfit = mlegp_fit(fam, x, y, k_single, jitter=jitter)
    if mlegp and sigma2 is None:
        sigma2 = kfit.sigma2
    fit = fit_combined_gp(spec, x, y, k_fit, mcmc=mcmc,
                          theta1_prior=theta1_prior,
                          theta2_prior=theta2_prior, sigma2=sigma2,
                          mle_family=mle_family, mle_ard=mle_ard,
                          jitter=jitter, device=dev)
    if on_unconverged != "ignore" and not fit.chain_ok:
        mc = fit.mcmc
        msg = (f"MCMC chain unhealthy: converged={bool(mc.converged)} "
               f"(Geweke p={float(mc.pvalue):.3f} < alpha="
               f"{mcmc.alpha_geweke}), n_recorded={int(mc.n_recorded)} vs "
               f"samp_size={mcmc.samp_size} after {int(mc.n_proposals)} "
               "proposals; the retained window duplicates draws if "
               "under-filled. Raise n_max/max_proposals or pass "
               "on_unconverged='ignore'.")
        if on_unconverged == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    quant_ref = (torch.as_tensor(np.asarray(y_true), dtype=x.dtype,
                                 device=dev) if quant_vs_truth else None)
    pred = predict_combined_gp(spec, fit, x, x_new, k_pred, alpha=alpha,
                               quant_ref=quant_ref, device=dev)
    predictions = {"combined": ModelPrediction(
        _np(pred.mean), _np(pred.lower), _np(pred.upper), _np(pred.quant))}

    if run_single:
        if kfit is None:
            kfit = kriging_mle(fam, x, y, k_single, ard=mle_ard,
                               jitter=jitter)
        with trace.span("single"):
            kpred = kriging_predict(
                fam, x, y, kfit, x_new, alpha=alpha,
                variant="mlegp" if mlegp else "reference")
        predictions["single"] = ModelPrediction(
            _np(kpred.mean), _np(kpred.lower), _np(kpred.upper))
    cfit = None
    if run_cgp:
        cfit = cgp_fit(x, y, k_cgp, n_candidates=cgp_candidates)
        cpred = cgp_predict(cfit, x_new)
        predictions["cgp"] = ModelPrediction(
            _np(cpred.mean), _np(cpred.lower), _np(cpred.upper))

    summary = comparison_summary(np.asarray(y_true), predictions)
    min_ess = float(torch.min(effective_sample_size(fit.zs[None])))
    return StudyResult(summary=summary, fit=fit, predictions=predictions,
                       y_true=np.asarray(y_true), min_ess=min_ess,
                       single_fit=kfit, cgp_fit=cfit)
