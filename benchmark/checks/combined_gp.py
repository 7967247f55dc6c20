"""The correctness check of the combined GP (configurations with
"system": "combined_gp"): what the timed path produced, against the plain
reference (`reference/combined_gp.py`, `reference/geweke.py`) in float64.

The reference follows the program where it cannot replay it: it takes
the program's plug-in rate, the Laplace mode and covariance the chain
started from, and the recorded draws. Each of those is judged on its own
terms, and everything else is worked out again from the inputs and the
request's key. Numbers, each a maximum over the checked requests:

  plugin       sigma2 and beta at the program's rate: |sigma2 - ref| / ref,
               |beta - ref| / sqrt(sigma2_ref)
  plugin_opt   the profile objective (log det R + n log sigma2_hat) at
               the program's rate less that at the reference's answer:
               the specified grid replayed ("grid"), or the least point
               of the box by a dense scan ("bfgs"), in nats (0 if better)
  laplace_mode how far the log-posterior rises from the program's mode
               under the reference's own ascent (L-BFGS in float64), nats
  laplace_cov  |cov - C|_ij / sqrt(C_ii C_jj), C the reference's Laplace
               covariance at the program's mode
  chain        exact: recorded steps that match no proposal of the
               request's stream (the proposal scale times the Laplace
               factor times the threefry normals, round by round) or
               match them out of order, proposals counted otherwise than
               the program counted, a claimed stop off a Geweke boundary,
               and retained draws that are not the chain's tail
  accept       every proposal the chain made, replayed from the stream:
               the margin in nats by which a decision went against
               logpost(candidate) - logpost(state) > log u (the first
               such candidate of a round is taken, the rest not looked
               at; a candidate whose log-posterior the reference cannot
               make finite, a Gram singular in float64, is rejected); 0
               where every decision stands
  geweke       at every Geweke boundary of the recorded chain the margin
               in p-value by which the decision to go on or to stop went
               against p >= alpha_geweke
  logpost      |logpost - ref| over the recorded draws, nats (the fused
               rounds kernel's arithmetic)
  draw_beta    |beta - ref| / sqrt(sigma2_ref) over the retained draws'
               intercepts in the factors predict uses
  moments      |mean - ref| / sqrt(sigma2_ref) and |var - ref| / sigma2_ref
               per draw and point (the decoded stash factors)
  intervals    |point prediction, lower, upper - ref| / sqrt(sigma2_ref)
               (the MC intervals, the reference drawing the same normals)

The control takes the program's place: the reference in a lower
precision, following the same program state, judged the same way.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from harness.check import gap, largest
from reference import combined_gp as ref
from reference import geweke, threefry


def _decisions(delta64, log_u, took) -> float:
    """The largest margin by which a decision `took` (accept, or stop) went
    against delta64 > log_u (delta64 >= threshold for Geweke). Where
    delta64 is not finite the only right decision is not to take."""
    against = torch.where(took, log_u - delta64, delta64 - log_u)
    bad = ~torch.isfinite(delta64)
    against = torch.where(bad, torch.where(took, math.inf, 0.0).to(
        against.dtype), against)
    return max(0.0, largest(against))


def _match(steps: np.ndarray, deltas: np.ndarray, states: np.ndarray):
    """For each recorded step (N, dim) the index of the proposal delta
    (P, dim) it equals to rounding, or -1: nearest neighbours along one
    direction, then the closest of those in every coordinate."""
    if steps.shape[0] == 0:
        return np.zeros(0, np.int64)
    if deltas.shape[0] == 0:
        return np.full(steps.shape[0], -1, np.int64)
    w = np.linspace(1.0, 2.0, steps.shape[1])
    dp = deltas @ w
    order = np.argsort(dp, kind="stable")
    i = np.searchsorted(dp[order], steps @ w)
    near = order[np.clip(i[:, None] + np.arange(-3, 3), 0, len(order) - 1)]
    dist = np.abs(steps[:, None, :] - deltas[near]).max(-1)
    best = np.argmin(dist, axis=1)
    pos = near[np.arange(len(best)), best]
    scale = 1.0 + np.abs(states[:-1]).max(-1) + np.abs(steps).max(-1)
    ok = dist[np.arange(len(best)), best] <= 1e-3 * scale
    return np.where(ok, pos, -1)


class Check:
    """The reference's side of one configuration."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.model = ref.Model.from_config(cfg)
        self.jitter = float(cfg["jitter"])
        self.draw_dtype = getattr(torch, cfg["dtype"])
        self.search = cfg["plugin_search"]

    # -- the fit ----------------------------------------------------------

    def _search(self, x, y, prec):
        s = self.search
        if self.cfg["plugin"] == "grid":
            return ref.grid_search(x, y, self.jitter, s["box"], s["grid"],
                                   s["zoom"], prec)
        return ref.scan_search(x, y, self.jitter, s["box"], prec=prec)

    def fit(self, design, fo, prec=None) -> dict:
        """The fit's numbers for the program (prec None) or the control."""
        x, y = design.x, design.y
        want = ref.plugin(x, y, fo.theta, self.jitter)
        s2 = want["sigma2"]
        sd = torch.sqrt(s2)
        got = (ref.plugin(x, y, fo.theta, self.jitter, prec) if prec
               else {"sigma2": fo.sigma2, "beta": fo.beta})
        out = {"plugin": max(gap(got["sigma2"], s2, s2),
                             gap(got["beta"], want["beta"], sd))}

        lt = (self._search(x, y, prec) if prec
              else torch.log(fo.theta.double()))
        obj = ref.profile_objective(
            x, y, torch.stack([lt.double().to(x.device),
                               self._search(x, y, ref.F64)]), self.jitter)
        out["plugin_opt"] = max(0.0, largest(obj[:1] - obj[1:]))

        out["laplace_mode"] = ref.mode_gain(self.model, x, y, s2, fo.mode,
                                            self.jitter)
        c = ref.laplace_at(self.model, x, y, s2, fo.mode, self.jitter)
        cov = (ref.laplace_at(self.model, x, y, s2, fo.mode, self.jitter,
                              prec) if prec else fo.cov)
        sds = torch.sqrt(torch.diagonal(c))
        out["laplace_cov"] = gap(cov, c, sds[:, None] * sds[None, :])

        out.update(self._chain(x, y, s2, fo, prec))
        zs_ref = ref.logpost(self.model, x, y, s2, fo.zs, self.jitter)
        betas = (ref.logpost(self.model, x, y, s2, fo.zs, self.jitter,
                             prec)["beta"] if prec else fo.betas)
        out["draw_beta"] = gap(betas, zs_ref["beta"], sd)
        return out

    def _chain(self, x, y, s2, fo, prec) -> dict:
        cfg, dev = self.cfg, x.device
        K, dim = int(cfg["speculative"]), fo.chain.shape[1]
        n, rounds = fo.chain.shape[0], int(fo.n_rounds)
        _, key = threefry.split(fo.key.to(dev), 2)
        eps, log_u = threefry.round_draws(key, rounds, K, dim,
                                          self.draw_dtype)
        # the proposals as the configuration's dtype makes them: the
        # factor of an eigenvalue-clipped covariance (condition up to 1e4)
        # moves by 1e4 ulps between precisions
        chol = torch.linalg.cholesky(cfg["proposal_cov_scale"]
                                     * fo.cov.to(self.draw_dtype).to(dev))
        deltas = (eps @ chol.T).double().reshape(rounds * K, dim)
        states = torch.cat([fo.mode.reshape(1, dim),
                            fo.chain]).double().to(dev)
        st = states.cpu().numpy()
        pos = _match(np.diff(st, axis=0), deltas.cpu().numpy(), st)
        r_acc, k_acc = pos // K, pos % K
        unreadable = int((pos < 0).sum()) + int(
            (np.diff(np.concatenate([[-1], r_acc])) <= 0).sum())
        bad = unreadable

        net = int(cfg["net_samp_size"])
        tail = torch.clamp(n - net + torch.arange(net, device=dev), 0,
                           max(n - 1, 0))
        zs = fo.zs.double().to(dev)
        if zs.shape != (net, dim) or n == 0:
            bad += abs(zs.shape[0] - net) + (n == 0)
        else:
            bad += int((zs != states[1:][tail]).any(-1).sum())

        batch = int(cfg["batch_size"])
        first = -(-int(cfg["samp_size"]) // batch) * batch
        boundaries = np.arange(first, n + 1, batch)
        stop = np.zeros(len(boundaries), bool)
        if fo.converged:
            if len(boundaries) and boundaries[-1] == n:
                stop[-1] = True
            else:
                bad += 1
        out = {"chain": float(bad), "accept": math.inf,
               "geweke": math.inf, "logpost": math.inf}
        if unreadable:
            return out

        # every proposal the chain looked at, round by round
        rr = np.arange(rounds)
        s_of_r = np.searchsorted(r_acc, rr, side="left")
        hit = s_of_r < n
        hit[hit] = r_acc[s_of_r[hit]] == rr[hit]
        looked = np.where(hit, k_acc[np.minimum(s_of_r, max(n - 1, 0))] + 1,
                          K) if n else np.full(rounds, K)
        out["chain"] += abs(int(looked.sum()) - int(fo.n_proposals))
        r_of = np.repeat(rr, looked)
        k_of = np.arange(looked.sum()) - np.repeat(np.cumsum(looked)
                                                   - looked, looked)
        s_of = s_of_r[r_of]
        took = hit[r_of] & (k_of == k_acc[np.minimum(s_of, max(n - 1, 0))]
                            if n else np.zeros(len(r_of), bool))
        idx = torch.as_tensor(r_of * K + k_of, device=dev)
        s_t = torch.as_tensor(s_of, device=dev)
        took_t = torch.as_tensor(took, device=dev)
        cands = torch.where(took_t[:, None], states[torch.clamp(s_t + 1,
                                                                max=n)],
                            states[s_t] + deltas[idx])
        lu = log_u.double().reshape(-1)[idx]

        def deltas_of(p):
            lp = ref.logpost(self.model, x, y, s2, torch.cat([states,
                                                              cands]),
                             self.jitter, p)["val"].double()
            return lp, lp[n + 1:] - lp[s_t]

        lp64, d64 = deltas_of(ref.F64)
        if prec:
            _, dp = deltas_of(prec)
            took_t = dp > lu
            chain_lp = ref.logpost(self.model, x, y, s2, states[1:],
                                   self.jitter, prec)["val"]
        else:
            chain_lp = fo.chain_lp
        out["accept"] = _decisions(d64, lu, took_t)
        out["logpost"] = gap(chain_lp, lp64[1:n + 1], 1.0)

        if len(boundaries):
            rows = (torch.as_tensor(boundaries - cfg["samp_size"],
                                    device=dev)[:, None]
                    + torch.arange(cfg["samp_size"], device=dev))
            windows = states[1:][rows]
            p64 = geweke.pvalue(windows)
            took_g = torch.as_tensor(stop, device=dev)
            if prec:
                took_g = (geweke.pvalue(windows.to(prec.dtype)).double()
                          >= cfg["alpha_geweke"])
            out["geweke"] = _decisions(p64, torch.full_like(
                p64, cfg["alpha_geweke"]), took_g)
        else:
            out["geweke"] = 0.0
        return out

    # -- predict ----------------------------------------------------------

    def predict(self, design, x_new, key, fo, po, prec=None) -> dict:
        """The query's numbers for the program (prec None) or the
        control."""
        s2 = ref.plugin(design.x, design.y, fo.theta, self.jitter)["sigma2"]
        want = self._predict(design, x_new, key, s2, fo.zs, ref.F64)
        if prec:
            s2p = ref.plugin(design.x, design.y, fo.theta, self.jitter,
                             prec)["sigma2"]
            got = self._predict(design, x_new, key, s2p, fo.zs, prec)
        else:
            got = {"dm": po.draw_mean, "dv": po.draw_var, "mean": po.mean,
                   "lower": po.lower, "upper": po.upper}
        s2 = s2.double()
        sd = torch.sqrt(s2)
        if got["dm"].shape != want["dm"].shape:
            return {"moments": math.inf, "intervals": math.inf}
        return {"moments": max(gap(got["dm"], want["dm"], sd),
                               gap(got["dv"], want["dv"], s2)),
                "intervals": max(gap(got[k], want[k], sd)
                                 for k in ("mean", "lower", "upper"))}

    def _predict(self, design, x_new, key, s2, zs, prec) -> dict:
        mo = ref.moments(self.model, design.x, design.y, x_new, s2, zs,
                         self.jitter, prec)
        iv = ref.intervals(key, mo["mean"], mo["var"], self.cfg["alpha"],
                           self.draw_dtype, prec)
        return {"dm": mo["mean"], "dv": mo["var"], **iv}
