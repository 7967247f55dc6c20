"""The correctness check of the comparison study (configurations with
"system": "study"): what the timed path produced, against the plain
reference (`reference/study.py` for mlegp's ARD GP, the composite GP and
the table; `reference/combined_gp.py` through `checks/combined_gp.py` for
the combined GP) in float64.

The reference follows the program's fitted parameters and judges each on
its own terms: how far its own descent lowers the program's optimum, and
everything else worked out again at those parameters. Numbers, each a
maximum over the checked requests:

  mlegp_nll    |nll - ref| at the program's rates, nats (the profile
               criterion log det R + n log sigma2)
  mlegp_opt    how far the reference's descent (float64, in the log-rate
               box) lowers the nll from the program's rates, nats
  mlegp_best   how far below the program's nll the reference's descents
               from the search's specified starts (the configuration's
               `mlegp`: `reference.study.ard_starts`) reach, nats (0 if
               none is lower): a search that keeps a worse start's answer
  single_pred  |mean, lower, upper - ref| / sqrt(sigma2_ref) of the single
               GP (mlegp's predictor and t intervals) at the program's
               rates
  cgp_obj      |objective - ref| at the program's w, nats
  cgp_opt      how far the reference's descent (float64, in the box)
               lowers the objective from the program's w, nats
  cgp_rmscv    |RMSCV - ref| / ref, the jackknife at the fitted rates
  cgp_pred     |mean, lower, upper - ref| / sqrt(tau2_ref) of predict.CGP
  summary      the program's table against the one `reference.study.
               summary` makes of its three predictions and the test
               responses: |RMSPE - ref| / ref, |coverage - ref|,
               |calibration quantile - ref|

and for the combined GP the numbers of `checks/combined_gp.py` but two:
`plugin` is judged as sigma2 and beta at mlegp's rates (the study's
plug-in), whose search `mlegp_opt` and `mlegp_best` judge in place of
`plugin_opt`, and `moments` is not read (run_study keeps the intervals,
not the per-draw moments, which the intervals are made of).

The control takes the program's place: the reference in a lower
precision at the program's parameters (the descents follow the
program's rates and w, as `laplace_mode` follows its mode); its summary
is the table of its own predictions against that of the float64
reference's.
"""
from __future__ import annotations

import math

import torch

from harness.check import gap, largest
from harness.spec import load_module
from reference import combined_gp as ref
from reference import study as rs
from reference import threefry


class Check:
    """The reference's side of one configuration."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.gp = load_module("checks", "combined_gp").Check(
            dict(cfg, plugin="bfgs", plugin_search=None))
        self.jitter = float(cfg["jitter"])

    @staticmethod
    def _keys(key):
        """run_study's split of the study key: (fit, predict, composite
        GP, single GP)."""
        return threefry.split(key, 4)

    # -- the fits ---------------------------------------------------------

    def fit(self, design, fo, prec=None) -> dict:
        x, y = design.x, design.y
        out = self._mlegp(x, y, fo, prec)
        out.update(self._cgp(x, y, fo, prec))
        out.update(self._combined(x, y, fo.combined, prec))
        return out

    def _mlegp(self, x, y, fo, prec) -> dict:
        m = self.cfg["mlegp"]
        lt = torch.log(fo.mlegp_theta.double()).to(x.device)
        want = rs.ard_nll(x, y, lt[None])[0]
        got = (rs.ard_nll(x, y, lt[None], prec)[0] if prec
               else fo.mlegp_nll)
        starts = torch.cat([lt[None], rs.ard_starts(
            x, y, self._keys(fo.key.to(x.device))[3], m["n_random"],
            m["box"], self.jitter)])
        _, best = rs.ard_descend(x, y, starts, m["box"])
        if not math.isfinite(float(want)):
            return {"mlegp_nll": math.inf, "mlegp_opt": math.inf,
                    "mlegp_best": math.inf}
        return {"mlegp_nll": gap(got, want, 1.0),
                "mlegp_opt": max(0.0, largest(want - best[0])),
                "mlegp_best": max(0.0, largest(want - best[1:].min()))}

    def _cgp(self, x, y, fo, prec) -> dict:
        c = fo.cgp
        w = rs.cgp_w(x, c["theta"], c["alpha"], c["lam"], c["bandwidth"])
        x_std, _ = rs.cgp_scale(x.double())
        want = rs.cgp_objective(x_std, y, w[None])[0]
        got = (rs.cgp_objective(x_std, y, w[None], prec)[0] if prec
               else c["objval"])
        _, best = rs.cgp_descend(x, y, w[None])
        args = (c["theta"], c["alpha"], c["lam"], c["bandwidth"])
        cv = rs.cgp_jackknife(x, y, *args)
        cv_got = rs.cgp_jackknife(x, y, *args, prec) if prec else c["rmscv"]
        return {"cgp_obj": gap(got, want, 1.0),
                "cgp_opt": max(0.0, largest(want - best[0])),
                "cgp_rmscv": gap(cv_got, cv, cv)}

    def _combined(self, x, y, fo, prec) -> dict:
        """checks/combined_gp.py's fit numbers at mlegp's plug-in."""
        gp, jitter = self.gp, self.jitter
        want = ref.plugin(x, y, fo.theta, jitter)
        s2 = want["sigma2"]
        sd = torch.sqrt(s2)
        got = (ref.plugin(x, y, fo.theta, jitter, prec) if prec
               else {"sigma2": fo.sigma2, "beta": fo.beta})
        out = {"plugin": max(gap(got["sigma2"], s2, s2),
                             gap(got["beta"], want["beta"], sd))}
        out["laplace_mode"] = ref.mode_gain(gp.model, x, y, s2, fo.mode,
                                            jitter)
        c = ref.laplace_at(gp.model, x, y, s2, fo.mode, jitter)
        cov = (ref.laplace_at(gp.model, x, y, s2, fo.mode, jitter, prec)
               if prec else fo.cov)
        sds = torch.sqrt(torch.diagonal(c))
        out["laplace_cov"] = gap(cov, c, sds[:, None] * sds[None, :])
        out.update(gp._chain(x, y, s2, fo, prec))
        zs_ref = ref.logpost(gp.model, x, y, s2, fo.zs, jitter)
        betas = (ref.logpost(gp.model, x, y, s2, fo.zs, jitter,
                             prec)["beta"] if prec else fo.betas)
        out["draw_beta"] = gap(betas, zs_ref["beta"], sd)
        return out

    # -- the predictions --------------------------------------------------

    def predict(self, design, x_new, key, fo, po, prec=None) -> dict:
        x, y = design.x, design.y
        alpha = self.cfg["alpha"]
        k_pred = self._keys(fo.key.to(x.device))[1]
        comb = fo.combined
        s2 = ref.plugin(x, y, comb.theta, self.jitter)["sigma2"].double()
        want = {"combined": self.gp._predict(design, x_new, k_pred, s2,
                                             comb.zs, ref.F64)}
        lt = torch.log(fo.mlegp_theta.double()).to(x.device)
        want["single"] = rs.ard_predict(x, y, lt, x_new, alpha)
        c = fo.cgp
        args = (c["theta"], c["alpha"], c["lam"], c["bandwidth"], x_new)
        want["cgp"] = rs.cgp_predict(x, y, *args)
        if prec:
            s2p = ref.plugin(x, y, comb.theta, self.jitter, prec)["sigma2"]
            got = {"combined": self.gp._predict(design, x_new, k_pred, s2p,
                                                comb.zs, prec),
                   "single": rs.ard_predict(x, y, lt, x_new, alpha, prec),
                   "cgp": rs.cgp_predict(x, y, *args, prec)}
        else:
            got = {"combined": po.combined, "single": po.single,
                   "cgp": po.cgp}
        # sigma2 at mlegp's rates scales both the combined GP and mlegp's
        scale = {"combined": torch.sqrt(s2), "single": torch.sqrt(s2),
                 "cgp": torch.sqrt(want["cgp"]["tau2"])}
        ends = ("mean", "lower", "upper")
        err = {name: max(gap(torch.as_tensor(got[name][k]), want[name][k],
                             scale[name]) for k in ends)
               for name in want}
        out = {"intervals": err["combined"], "single_pred": err["single"],
               "cgp_pred": err["cgp"]}
        out["summary"] = self._summary(fo.y_test, got, po, want, prec)
        return out

    @staticmethod
    def _summary(y_test, got, po, want, prec) -> float:
        """The worst gap between a table and the one the reference makes:
        the program's own table against the reference's table of the
        program's predictions (its quantiles included), or the control's
        predictions' table against the float64 reference's (quantiles
        left out: the reference makes none)."""
        def table(p, quant=None):
            preds = {name: {k: torch.as_tensor(p[name][k]).cpu()
                            for k in ("mean", "lower", "upper")}
                     for name in ("combined", "single", "cgp")}
            preds["combined"]["quant"] = quant
            return rs.summary(y_test, preds)

        if prec:
            have, ref_t = table(got), table(want)
        else:
            have, ref_t = po.summary, table(got, torch.as_tensor(po.quant))
        gaps = [abs(have["quantile"] - ref_t["quantile"])
                if ref_t["quantile"] is not None else 0.0]
        for name, r in ref_t["rmspe"].items():
            gaps.append(abs(have["rmspe"][name] - r) / r)
            gaps.append(abs(have["coverage"][name] - ref_t["coverage"][name]))
        worst = max(gaps)
        return worst if math.isfinite(worst) else math.inf
