"""The system under test for configurations with "system": "study": the
paper's three-way comparison study, `ccgp_tpu_torch.experiments.common.
run_study` with the mlegp ARD GP as the plug-in and single-GP baseline and
the composite GP, set up from a configuration file. The package is
imported only inside the functions that call it.

A request is one study. `fit` only keeps the request's design and key:
`predict` runs the study with that key (run_study splits it into the
combined GP's fit and predict keys, the composite GP's and mlegp's), so
the request's latency holds the fits and the predictions together. The
study's summary needs the split's test responses: set-up maps each split
of the configuration's `data_file` from its training responses to them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from harness.spec import ROOT, load_json, load_module

# the traced run's spans: none, the readers read the program's tracer
SPANS = {}


class Request:
    """A study request: its design, key and the split's test responses;
    `predict` keeps the study's result on it."""

    def __init__(self, x, y, key, y_test):
        self.x, self.y, self.key, self.y_test = x, y, key, y_test
        self.result = None


class Answer(NamedTuple):
    """The study's result and `mean`, the tensor the harness reads to see
    that the program answered on the card: `run_study` hands its
    predictions back as numpy arrays, so this is the combined GP's
    retained draws, which the study made on the device."""

    result: Any
    mean: torch.Tensor


class FitOut(NamedTuple):
    """What the correctness check reads of a study: the request's key (the
    study's), the combined GP's fit in the form `checks/combined_gp.py`
    reads (its plug-in mlegp's rate, beta and sigma^2), mlegp's rates and
    nll, the composite GP's fit, and the split's test responses."""

    key: torch.Tensor
    combined: Any        # systems/combined_gp.FitOut
    mlegp_theta: torch.Tensor
    mlegp_nll: torch.Tensor
    cgp: dict            # lam, theta, alpha, bandwidth, objval, rmscv
    y_test: np.ndarray


class PredOut(NamedTuple):
    """The three models' means and interval ends (numpy, as run_study
    gives them), the combined GP's calibration quantiles and the study's
    summary."""

    combined: dict       # mean, lower, upper
    quant: np.ndarray
    single: dict         # mean, lower, upper
    cgp: dict
    summary: dict        # rmspe, coverage, quantile


def _test_responses(cfg: dict) -> dict:
    """Each split's training responses (as bytes of float64) -> its test
    responses."""
    data = load_json(ROOT / cfg["data_file"])
    pts = np.asarray(data["points"], dtype=np.float64)
    d = cfg["dim"]
    return {pts[s["train"], d].tobytes(): pts[s["test"], d]
            for s in data["splits"]}


class System:
    def __init__(self, cfg: dict, device: str):
        from ccgp_tpu_torch.experiments.common import StudyResult
        from ccgp_tpu_torch.infer import mle
        from ccgp_tpu_torch.models import composite_gp

        # the check judges the fits the baselines predicted from
        missing = {"single_fit", "cgp_fit"} - set(StudyResult._fields)
        if missing:
            raise RuntimeError(f"run_study's StudyResult has no "
                               f"{sorted(missing)}: the check cannot judge "
                               f"the baselines' fits")
        self.cfg, self.device = cfg, device
        self.dtype = getattr(torch, cfg["dtype"])
        # run_study runs mlegp_fit's and cgp_fit's own searches: the
        # configuration has to state those
        m, c, d = cfg["mlegp"], cfg["cgp"], cfg["dim"]
        want = {"mlegp n_random": (m["n_random"], mle.MLEGP_N_RANDOM),
                "mlegp starts": (m["starts"], 1 + 4 * d + m["n_random"]),
                "mlegp maxiter": (m["maxiter"], mle.MLEGP_MAXITER),
                "mlegp box": (tuple(m["box"]), tuple(mle.MLEGP_LOG_THETA)),
                "cgp starts": (c["starts"], composite_gp.NUM_STARTS),
                "cgp jackknife": (c["jackknife"], True)}
        bad = {k: v for k, v in want.items() if v[0] != v[1]}
        if bad:
            raise ValueError(f"the configuration asks for searches run_study "
                             f"does not run (stated, run): {bad}")
        self.gp = load_module("systems", "combined_gp").System(cfg, device)
        self.tests = _test_responses(cfg)

    def fit(self, x, y, key) -> Request:
        y_test = self.tests[y.detach().cpu().double().numpy().tobytes()]
        return Request(x, y, key, y_test)

    def predict(self, fit: Request, x, x_new, key) -> Answer:
        from ccgp_tpu_torch.experiments.common import run_study

        cfg, gp = self.cfg, self.gp
        fit.result = run_study(
            gp.spec, fit.x, fit.y, x_new, fit.y_test, fit.key, gp.mcmc,
            alpha=cfg["alpha"], mle_ard=cfg["mle_ard"], run_cgp=True,
            cgp_candidates=cfg["cgp"]["candidates"], jitter=cfg["jitter"],
            on_unconverged="ignore", single_variant="mlegp",
            device=self.device, **gp.priors)
        return Answer(fit.result, fit.result.fit.zs)

    def fit_out(self, fit: Request, key) -> FitOut:
        from ccgp_tpu_torch.ops import rng

        res = fit.result
        k_fit = rng.split(fit.key, 4)[0]
        kf, cf = res.single_fit, res.cgp_fit
        comb = self.gp.fit_out(res.fit, k_fit)._replace(
            theta=kf.theta, beta=kf.beta)
        return FitOut(key=fit.key, combined=comb, mlegp_theta=kf.theta,
                      mlegp_nll=kf.nll,
                      cgp={k: getattr(cf, k) for k in (
                          "lam", "theta", "alpha", "bandwidth", "objval",
                          "rmscv")},
                      y_test=fit.y_test)

    @staticmethod
    def pred_out(pred: Answer) -> PredOut:
        res = pred.result
        p = res.predictions
        c = p["combined"]
        s = res.summary
        ends = lambda m: {"mean": m.mean, "lower": m.lower,  # noqa: E731
                          "upper": m.upper}
        return PredOut(combined=ends(c), quant=c.quant,
                       single=ends(p["single"]), cgp=ends(p["cgp"]),
                       summary={"rmspe": dict(s.rmspe),
                                "coverage": dict(s.coverage),
                                "quantile": s.average_quantile})

    @staticmethod
    def failed(fit: Request, pred: Answer) -> bool:
        """Unusable: the combined GP's chain is unhealthy, or a model's
        prediction is not finite."""
        res = pred.result
        if not res.fit.chain_ok:
            return True
        return not all(np.isfinite(a).all() for m in res.predictions.values()
                       for a in (m.mean, m.lower, m.upper))

    def chain(self, fit: Request) -> dict:
        return self.gp.chain(fit.result.fit)

    def load(self):
        self.gp.load()

    def launches(self) -> dict:
        return self.gp.launches()
