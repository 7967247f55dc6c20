"""Faults planted in the timed path of the combined GP, each one a way the
program could go wrong that `correct` has to catch: used by the tests of
`correct` and by `harness/readings.py --fault` for the upper readings.
`plant(name)` patches the names the port's modules call, and restores
them on exit."""
from __future__ import annotations

import contextlib
import importlib
import math


def _stuck(metropolis):
    """The chain returns its first state over and over."""
    def broken(*a, **kw):
        res = metropolis(*a, **kw)
        keep = lambda t: t[:1].expand_as(t).clone()  # noqa: E731
        return res._replace(samples=keep(res.samples), betas=keep(res.betas),
                            logposts=keep(res.logposts))
    return broken


def _half_mean(posterior_predict):
    """The point prediction averages half of the draws."""
    def broken(key, dm, dv, **kw):
        out = posterior_predict(key, dm, dv, **kw)
        return out._replace(mean=dm[dm.shape[0] // 2:].mean(0))
    return broken


def _altered(predict):
    """One answer is moved where it is produced."""
    def broken(*a, **kw):
        out = predict(*a, **kw)
        mean = out.mean.clone()
        mean[0] = mean[0] + 0.05 * out.mean.abs().max()
        return out._replace(mean=mean)
    return broken


def _worse_optimum(mle):
    """The plug-in lands on a worse rate (e^0.5 times the found one), with
    beta and sigma2 worked out at it: self-consistent, but not the
    optimum."""
    def broken(family, x, y, *a, **kw):
        from ccgp_tpu_torch.ops import gp, linalg

        m = mle(family, x, y, *a, **kw)
        theta = m.theta * math.exp(0.5)
        chol = linalg.jitter_cholesky(family.gram(x, theta),
                                      kw.get("jitter", 1e-10))
        beta = gp.gls_beta(chol, y)
        return m._replace(theta=theta, beta=beta, chol=chol,
                          sigma2=gp.sigma2_mle(chol, y, beta),
                          nll=gp.profile_nll(chol, y))
    return broken


def _truncated(mle):
    """The multistart BFGS stops before its first iteration: the best of
    its starts."""
    def broken(*a, **kw):
        return mle(*a, **dict(kw, maxiter=0))
    return broken


def _lenient(make_mh_rounds):
    """Every acceptance test is 1 nat too lenient."""
    def broken(*a, **kw):
        rounds = make_mh_rounds(*a, **kw)
        return lambda z, v, b, deltas, log_u: rounds(z, v, b, deltas,
                                                     log_u - 1.0)
    return broken


def _no_ascent(laplace):
    """The Laplace fit keeps its start as the mode."""
    def broken(fn, start, maxiter=100):
        return laplace(fn, start, maxiter=0)
    return broken


def _early_stop(geweke_pvalue):
    """The Geweke test reads every p-value 0.5 too high: the chain stops
    at its first check, converged or not."""
    def broken(samples, *a, **kw):
        return geweke_pvalue(samples, *a, **kw) + 0.5
    return broken


_CG = "ccgp_tpu_torch.models.combined_gp"
FAULTS = {
    "state_unchanged": ((_CG, "metropolis"),),
    "half_batch_mean": ((_CG, "posterior_predict"),),
    "answer_altered": ((_CG, "predict_combined_gp"),),
    "worse_optimum": ((_CG, "kriging_mle"), (_CG, "kriging_mle_grid")),
    "bfgs_truncated": ((_CG, "kriging_mle"),),
    "lenient_accept": ((_CG, "make_mh_rounds"),),
    "laplace_at_start": (("ccgp_tpu_torch.infer.metropolis", "laplace"),),
    "geweke_early": (("ccgp_tpu_torch.infer.metropolis", "geweke_pvalue"),),
}
_MAKE = {"state_unchanged": _stuck, "half_batch_mean": _half_mean,
         "answer_altered": _altered, "worse_optimum": _worse_optimum,
         "bfgs_truncated": _truncated, "lenient_accept": _lenient,
         "laplace_at_start": _no_ascent, "geweke_early": _early_stop}


@contextlib.contextmanager
def plant(name: str):
    saved = [(importlib.import_module(m), a) for m, a in FAULTS[name]]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    try:
        for m, a, fn in saved:
            setattr(m, a, _MAKE[name](fn))
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
