"""Faults planted in the timed path of the comparison study, each one a way
the program could go wrong that `correct` has to catch: used by the tests
of `correct` and by `harness/readings.py --fault` for the upper readings.
`plant(name)` patches the names the port's modules call, and restores
them on exit. The combined GP's faults that reach it inside a study
(`COMBINED`) are planted through `faults/combined_gp.py`."""
from __future__ import annotations

import contextlib
import importlib

from harness.spec import load_module


def _first_start(mlegp_fit):
    """mlegp keeps its first start's solution rather than the best."""
    def broken(*a, **kw):
        from ccgp_tpu_torch.infer import mle

        search = mle.multistart_minimize

        def first(*sa, **skw):
            res = search(*sa, **skw)
            return res._replace(x=res.xs[0], fun=res.funs[0])

        mle.multistart_minimize = first
        try:
            return mlegp_fit(*a, **kw)
        finally:
            mle.multistart_minimize = search
    return broken


def _one_iteration(sigma_iterations):
    """The composite GP re-estimates its local variances once, not four
    times."""
    def broken(g, l, gbw, lam, y, n_iter=4):
        return sigma_iterations(g, l, gbw, lam, y, n_iter=1)
    return broken


def _unrefined(multistart_minimize):
    """The composite GP's bounded BFGS stops before its first iteration:
    the best of the top candidates, unrefined."""
    def broken(*a, **kw):
        return multistart_minimize(*a, **dict(kw, maxiter=0))
    return broken


def _wrong_point(jackknife):
    """The jackknife leaves out point j + 1 (mod n) but predicts point j:
    the RMSCV of the held-out points shifted by one."""
    def broken(x, y, theta, alpha, lam, bwv):
        import torch

        from ccgp_tpu_torch.models import composite_gp as cg
        from ccgp_tpu_torch.ops import linalg

        n, dev = x.shape[0], x.device
        keep = torch.stack([torch.cat([torch.arange((j + 1) % n, device=dev),
                                       torch.arange((j + 1) % n + 1, n,
                                                    device=dev)])
                            for j in range(n)])
        xs, ys = x[keep], y[keep]
        sigj, sfj, ej, cholj, betaj, _ = cg._factor(xs, ys, theta, alpha,
                                                     lam, bwv)
        tempj = linalg.chol_solve(cholj, ys - betaj[..., None])
        dj = (xs - x[:, None, :]) ** 2
        gv = torch.exp(-torch.sum(theta * dj, dim=-1))
        lv = torch.exp(-torch.sum(alpha * dj, dim=-1))
        gbv = torch.exp(-torch.sum(theta * bwv * dj, dim=-1))
        vj = cg._vdot(gbv, ej * ej) / cg._vdot(gbv, torch.ones_like(ys)) / sfj
        qv = gv + lam * torch.sqrt(vj)[:, None] * torch.sqrt(sigj) * lv
        yjf = betaj + cg._vdot(qv, tempj)
        return torch.sqrt(torch.mean((y - yjf) ** 2))
    return broken


_CGP = "ccgp_tpu_torch.models.composite_gp"
FAULTS = {
    "mlegp_first_start": (("ccgp_tpu_torch.experiments.common",
                           "mlegp_fit"),),
    "cgp_one_iteration": ((_CGP, "_sigma_iterations"),),
    "cgp_unrefined": ((_CGP, "multistart_minimize"),),
    "jackknife_wrong_point": ((_CGP, "_jackknife"),),
}
_MAKE = {"mlegp_first_start": _first_start,
         "cgp_one_iteration": _one_iteration,
         "cgp_unrefined": _unrefined,
         "jackknife_wrong_point": _wrong_point}


# the combined GP's faults in the modules run_study reaches
COMBINED = ("laplace_at_start", "lenient_accept", "geweke_early")
FAULTS.update({name: load_module("faults", "combined_gp").FAULTS[name]
               for name in COMBINED})


@contextlib.contextmanager
def plant(name: str):
    if name in COMBINED:
        with load_module("faults", "combined_gp").plant(name):
            yield
        return
    saved = [(importlib.import_module(m), a) for m, a in FAULTS[name]]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    try:
        for m, a, fn in saved:
            setattr(m, a, _MAKE[name](fn))
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
