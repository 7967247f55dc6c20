"""Laplace-seeded random-walk Metropolis with Geweke stopping (port of
`ccgp_tpu/infer/metropolis.py`).

Reference semantics (`1D Codes and Designs/1D Combined GP Public.R:657-719`):
a fixed Gaussian proposal with covariance sqrt(2) V_hat (V_hat from the
Laplace fit), started at the Laplace mode; accepted-only recording (or
`record="all"`, the textbook chain); a Geweke test on the trailing
`samp_size` window every `batch_size` records past `samp_size`; stop when
its p-value reaches alpha_geweke, after n_max records or after
max_proposals proposals.

Three drivers over one random stream (round r: `key, k1, k2 =
split(key, 3)`, then `normal(k1, (K, dim))` and `log(uniform(k2, (K,)))`),
which they take only from `ops.rng.chunk_draws` (one launch on the card
per chunk, or per round):

* the K = 1 body (`speculative` <= 1, `body` in JAX): one proposal per
  round through `logpost`;
* the one-round speculative bodies (K > 1): `body_spec` evaluates the K
  candidates with `logpost_batch` (or `logpost` on the batch) and takes
  the first acceptance; `body_mh` hands the whole round to `mh_round`
  (`models.likelihood.make_mh_round`, one launch of the fused round
  kernel for SE/SE);
* the chunked driver (`mh_rounds`, K > 1, record="accepted"): each loop
  iteration runs a CHUNK of rounds through `mh_rounds` (one launch of the
  fused rounds kernel on the card), with the chunk's keys and draws
  from `ops.rng.chunk_draws`. Three phases batch the SAME rounds:
  check-free 120-round warm chunks while no Geweke boundary is reachable,
  check-free 20-round chunks, then the check-aware tail. Caps and the
  Geweke stop truncate a chunk to the prefix of rounds that the one-round
  sampler would have run, so the chain is draw-for-draw the sequential
  one.

`metropolis_lanes` runs L chains of the K = 1 body side by side (the
counterpart of `jax.vmap(metropolis)` at speculative=0): one batched
log-posterior per round for every lane, the lanes' draws `rr` rounds
ahead from one `ops.rng.chunk_draws_lanes` call.

The loop conditions live on the host: a one-round body reads its
acceptance back once per round, a chunk its acc/consumed flags once per
chunk. The Geweke statistic (a few hundred scalar operations) runs on the
host copy of its window. Each of the three runs as the span `sampler`,
with a `geweke` span per check and its rounds
counted as `rounds.kept`; the chunked one also spans each `chunk` and
counts the rounds it launched, `rounds.launched` (`utils.trace`).
"""
from __future__ import annotations

import math

import numpy as np
from typing import Callable, NamedTuple

import torch

from ccgp_tpu_torch.infer.geweke import geweke_pvalue
from ccgp_tpu_torch.infer.laplace import LaplaceFit, laplace
from ccgp_tpu_torch.models.likelihood import first_acceptance
from ccgp_tpu_torch.ops import rng
from ccgp_tpu_torch.utils import trace

ROUNDS_PER_CALL_WARM = 120


class MetropolisResult(NamedTuple):
    samples: torch.Tensor       # (n_max, dim) unconstrained draws
    betas: torch.Tensor         # (n_max,) GLS intercept per recorded draw
    logposts: torch.Tensor      # (n_max,) log-posterior (-inf unrecorded)
    n_recorded: int
    n_proposals: int
    n_accepted: int
    pvalue: float               # final Geweke p-value
    converged: bool             # stopped via Geweke (vs a cap)
    laplace: LaplaceFit
    factors: torch.Tensor | None = None   # stash rows, row i <-> sample i
    factors_ok: bool | None = None        # no stash write was clamped
    n_rounds: int | None = None           # speculative rounds run

    def retained(self, samp_size: int):
        """The last `samp_size` recorded draws (indices clamp into the
        recorded range when the chain recorded fewer)."""
        hi = max(self.n_recorded - 1, 0)
        idx = torch.clamp(self.n_recorded - samp_size
                          + torch.arange(samp_size,
                                         device=self.samples.device), 0, hi)
        return self.samples[idx], self.betas[idx], self.logposts[idx]

    def chain_ok(self, samp_size: int) -> bool:
        """Geweke-converged AND the retained window is fully recorded."""
        return bool(self.converged) and self.n_recorded >= samp_size


def metropolis(
    logpost: Callable,
    start: torch.Tensor,
    key: torch.Tensor,
    n_max: int,
    samp_size: int,
    batch_size: int = 20,
    alpha_geweke: float = 0.5,
    record: str = "accepted",
    proposal_cov_scale: float = 1.4142135623730951,
    laplace_maxiter: int = 100,
    max_proposals: int | None = None,
    laplace_fit: LaplaceFit | None = None,
    speculative: int = 0,
    logpost_batch: Callable | None = None,
    mh_round: Callable | None = None,
    mh_rounds: Callable | None = None,
    rounds_per_call: int = 20,
    rounds_per_call_warm: int = ROUNDS_PER_CALL_WARM,
    stash_rows: int | None = None,
    stash_lanes: int | None = None,
    stash_cap: int | None = None,
) -> MetropolisResult:
    """Run one chain.

    logpost(z) returns an object with `.val` and `.beta`; it gives the
    Laplace fit, the start state and, for K = 1, every proposal's value.
    With K = speculative > 1 the sampler is, in JAX's order of precedence:
    the chunked one when mh_rounds (`models.likelihood.make_mh_rounds`) is
    given, else `body_mh` when mh_round (`make_mh_round`) is given, else
    `body_spec` with logpost_batch (`make_logpost_batch`) or, without it,
    `logpost` on the (K, dim) batch. laplace_fit resumes from a saved
    Laplace approximation, starting at `start`. With stash_rows set, each
    recorded draw's stash row (stash_rows x stash_lanes) lands in
    `factors`, whose capacity `stash_cap` may be below the chain length: a
    chunk that could write past it clamps, and `factors_ok` turns False."""
    if record not in ("accepted", "all"):
        raise ValueError(record)
    if speculative and speculative > 1 and record != "accepted":
        raise ValueError("speculative proposals need record='accepted'")
    K = int(speculative) if speculative else 1
    dim = start.shape[-1]
    dtype, dev = start.dtype, start.device
    if max_proposals is None:
        max_proposals = 50 * n_max

    if laplace_fit is None:
        fit = laplace(lambda z: logpost(z).val, start,
                      maxiter=laplace_maxiter)
        z0 = fit.mode
    else:
        fit = laplace_fit
        z0 = start
    with torch.no_grad():
        if mh_rounds is not None and K > 1:
            return _chunked(logpost, z0, key, fit, n_max, samp_size,
                            batch_size, alpha_geweke, proposal_cov_scale,
                            max_proposals, K, mh_rounds, rounds_per_call,
                            rounds_per_call_warm, stash_rows, stash_lanes,
                            stash_cap, dim, dtype, dev)
        return _one_round(logpost, z0, key, fit, n_max, samp_size,
                          batch_size, alpha_geweke, proposal_cov_scale,
                          max_proposals, K, record, logpost_batch, mh_round,
                          dim, dtype, dev)


@trace.span("sampler")
def _one_round(logpost, z0, key, fit, n_max, samp_size, batch_size,
               alpha_geweke, proposal_cov_scale, max_proposals, K, record,
               logpost_batch, mh_round, dim, dtype, dev) -> MetropolisResult:
    """The one-round bodies (`body`, `body_spec`, `body_mh` in JAX): one
    round per loop iteration, its acceptance read back to the host."""
    prop_chol = torch.linalg.cholesky(proposal_cov_scale * fit.cov)
    lp0 = logpost(z0)
    # one packed row [z | beta | logpost] per record; the row at k_rec is
    # written every round and kept only when the round records
    P = torch.zeros((n_max, dim + 2), dtype=dtype, device=dev)
    key = key.to(dev)
    z, lpv, lpb = z0, lp0.val, lp0.beta
    k_rec = n_prop = n_acc = n_rnd = 0
    pv = 0.0
    while k_rec < n_max and pv < alpha_geweke and n_prop < max_proposals:
        # the round's keys and draws in one call; normal(k1, (K, dim)) and
        # uniform(k2, (K,)) hash the flat counters that K = 1's (dim,) and
        # () shapes hash
        key, eps, log_u = rng.chunk_draws(key, 1, K, dim, dtype)
        if K == 1:
            cand = z + prop_chol @ eps.reshape(dim)
            lp_c = logpost(cand)
            log_u = log_u.reshape(())
            accept = (lp_c.val - lpv) > log_u
            z = torch.where(accept, cand, z)
            lpv = torch.where(accept, lp_c.val, lpv)
            lpb = torch.where(accept, lp_c.beta, lpb)
            consumed = 1
        else:
            cands = z[None, :] + eps.reshape(K, dim) @ prop_chol.T
            log_u = log_u.reshape(K)
            if mh_round is not None:
                zc, vc, bc, accept, consumed = mh_round(z, lpv, lpb, cands,
                                                        log_u)
            else:
                if logpost_batch is not None:
                    vals, betas = logpost_batch(cands)
                else:
                    out = logpost(cands)
                    vals, betas = out.val, out.beta
                zc, vc, bc, accept, consumed = first_acceptance(
                    z, lpv, lpb, cands, vals, betas, log_u)
            z = torch.where(accept, zc, z)
            lpv = torch.where(accept, vc, lpv)
            lpb = torch.where(accept, bc, lpb)
        P[k_rec] = torch.cat([z, lpb.reshape(1), lpv.reshape(1)])
        acc_h = bool(trace.readback(accept))
        rec = acc_h or record == "all"
        k_rec += int(rec)
        n_acc += int(acc_h)
        n_prop += consumed if K == 1 else int(trace.readback(consumed))
        n_rnd += 1
        if rec and k_rec >= samp_size and k_rec % batch_size == 0:
            with trace.span("geweke"):
                pv = float(geweke_pvalue(trace.readback(
                    P[k_rec - samp_size:k_rec, :dim])))
    trace.count("rounds.kept", n_rnd)
    recorded = torch.arange(n_max, device=dev) < k_rec
    return MetropolisResult(
        samples=P[:, :dim], betas=P[:, dim],
        logposts=torch.where(recorded, P[:, dim + 1],
                             torch.full_like(P[:, dim + 1], -math.inf)),
        n_recorded=k_rec, n_proposals=n_prop, n_accepted=n_acc, pvalue=pv,
        converged=pv >= alpha_geweke, laplace=fit,
        n_rounds=n_rnd if K > 1 else n_prop)


@trace.span("sampler")
def _chunked(logpost, z0, key, fit, n_max, samp_size, batch_size,
             alpha_geweke, proposal_cov_scale, max_proposals, K, mh_rounds,
             rounds_per_call, rounds_per_call_warm, stash_rows, stash_lanes,
             stash_cap, dim, dtype, dev) -> MetropolisResult:
    prop_chol = torch.linalg.cholesky(proposal_cov_scale * fit.cov)
    lp0 = logpost(z0)
    # a chunk crosses at most one Geweke check boundary
    RR = min(int(rounds_per_call), batch_size)
    RW = max(RR, int(rounds_per_call_warm or 0))
    # +RW slack rows for chunk overshoot, +1 scratch row
    P = torch.zeros((n_max + RW + 1, dim + 2), dtype=dtype, device=dev)
    full = n_max + RW + 1
    st_cap = full if stash_cap is None else max(min(int(stash_cap), full),
                                                RW + 1)
    ST = (torch.zeros((st_cap, stash_rows, stash_lanes), dtype=dtype,
                      device=dev) if stash_rows else None)
    s = {"key": key.to(dev), "k_rec": 0, "n_prop": 0, "n_acc": 0,
         "n_rnd": 0, "pv": 0.0, "st_ok": True, "z": z0,
         "lpv": lp0.val, "lpb": lp0.beta}

    def chunk(rr: int, check: bool):
        with trace.span("chunk"):
            trace.count("rounds.launched", rr)
            key, eps, log_u = rng.chunk_draws(s["key"], rr, K, dim, dtype)
            deltas = eps.reshape(rr * K, dim) @ prop_chol.T
            out = mh_rounds(s["z"], s["lpv"], s["lpb"], deltas, log_u)
            flags = trace.readback(torch.stack(
                [out["acc"].to(torch.int64),
                 out["consumed"].to(torch.int64)]))
            acc, con = flags[0], flags[1]
            k_rec, n_prop = s["k_rec"], s["n_prop"]
            cum_acc = torch.cumsum(acc, 0)
            cum_con = torch.cumsum(con, 0)
            # a round ran iff every cap held before it: always a prefix
            runnable = (((n_prop + cum_con - con) < max_proposals)
                        & ((k_rec + cum_acc - acc) < n_max))
            pos = k_rec + cum_acc
            # accepted rows first (stable), landed as one slab at k_rec;
            # rows past the valid prefix are scratch that later chunks
            # overwrite
            idx = torch.arange(rr)
            order = torch.argsort(torch.where(acc > 0, idx, rr + idx)).to(dev)
            P[k_rec:k_rec + rr] = out["rec"][order]
            if ST is not None:
                if ST.shape[0] < full:
                    s["st_ok"] = s["st_ok"] and k_rec + rr <= ST.shape[0]
                row = min(k_rec, ST.shape[0] - rr)   # a clamped slab write
                ST[row:row + rr] = out["stash"][order]
        valid = runnable
        if check:
            check_round = (runnable & (acc > 0) & (pos >= samp_size)
                           & (pos % batch_size == 0))
            if bool(check_round.any()):
                with trace.span("geweke"):
                    first_chk = int(torch.argmax(check_round.to(torch.int64)))
                    pos_chk = int(pos[first_chk])
                    window = trace.readback(
                        P[pos_chk - samp_size:pos_chk, :dim])
                    s["pv"] = float(geweke_pvalue(window))
                if s["pv"] >= alpha_geweke:
                    valid = runnable & (idx <= first_chk)
        n_acc_c = int(torch.sum(torch.where(valid, acc, 0)))
        n_valid = int(torch.sum(valid))
        trace.count("rounds.kept", n_valid)
        s["k_rec"] += n_acc_c
        s["n_acc"] += n_acc_c
        s["n_prop"] += int(torch.sum(torch.where(valid, con, 0)))
        s["n_rnd"] += n_valid
        s["key"] = key
        s["z"], s["lpv"], s["lpb"] = (out["z_fin"], out["val_fin"],
                                      out["beta_fin"])

    def running():
        return (s["k_rec"] < n_max and s["pv"] < alpha_geweke
                and s["n_prop"] < max_proposals)

    # warm: no record position of an RW-round chunk can reach samp_size
    while s["k_rec"] + RW < samp_size and running():
        chunk(RW, check=False)
    if RR < RW:
        while s["k_rec"] + RR < samp_size and running():
            chunk(RR, check=False)
    while running():
        chunk(RR, check=True)

    k_rec = s["k_rec"]
    recorded = torch.arange(n_max, device=dev) < k_rec
    return MetropolisResult(
        samples=P[:n_max, :dim], betas=P[:n_max, dim],
        logposts=torch.where(recorded, P[:n_max, dim + 1],
                             torch.full_like(P[:n_max, dim + 1], -math.inf)),
        n_recorded=k_rec, n_proposals=s["n_prop"], n_accepted=s["n_acc"],
        pvalue=s["pv"], converged=s["pv"] >= alpha_geweke, laplace=fit,
        factors=ST, factors_ok=None if ST is None else s["st_ok"],
        n_rounds=s["n_rnd"])


# rounds of draws `metropolis_lanes` makes ahead per `chunk_draws_lanes`
LANES_DRAW_ROUNDS = 120


class LanesResult(NamedTuple):
    """`metropolis_lanes`' chains, each field with a leading lane axis L
    (the counters on the host). `lane(i)` is lane i as a MetropolisResult."""

    samples: torch.Tensor       # (L, n_max, dim)
    betas: torch.Tensor         # (L, n_max)
    logposts: torch.Tensor      # (L, n_max), -inf where unrecorded
    n_recorded: np.ndarray      # (L,) int64
    n_proposals: np.ndarray     # (L,)
    n_accepted: np.ndarray      # (L,)
    pvalue: np.ndarray          # (L,) final Geweke p-values
    converged: np.ndarray       # (L,) bool
    laplace: LaplaceFit         # mode (L, dim), cov (L, dim, dim), (L,)
    n_rounds: np.ndarray        # (L,) rounds run (= proposals at K = 1)

    def lane(self, i: int) -> MetropolisResult:
        fit = LaplaceFit(*(f[i] for f in self.laplace))
        return MetropolisResult(
            samples=self.samples[i], betas=self.betas[i],
            logposts=self.logposts[i], n_recorded=int(self.n_recorded[i]),
            n_proposals=int(self.n_proposals[i]),
            n_accepted=int(self.n_accepted[i]), pvalue=float(self.pvalue[i]),
            converged=bool(self.converged[i]), laplace=fit,
            n_rounds=int(self.n_rounds[i]))

    def retained(self, samp_size: int):
        """Each lane's last `samp_size` recorded draws, clamped into its
        recorded range as `MetropolisResult.retained`: (L, samp_size, ...)."""
        dev = self.samples.device
        k = torch.as_tensor(self.n_recorded, device=dev)[:, None]
        idx = torch.clamp(k - samp_size + torch.arange(samp_size, device=dev),
                          min=0)
        idx = torch.minimum(idx, torch.clamp(k - 1, min=0))
        lanes = torch.arange(idx.shape[0], device=dev)[:, None]
        return (self.samples[lanes, idx], self.betas[lanes, idx],
                self.logposts[lanes, idx])

    def chain_ok(self, samp_size: int) -> np.ndarray:
        return self.converged & (self.n_recorded >= samp_size)


def metropolis_lanes(
    logpost_lanes: Callable,
    starts: torch.Tensor,
    keys: torch.Tensor,
    n_max: int,
    samp_size: int,
    batch_size: int = 20,
    alpha_geweke: float = 0.5,
    record: str = "accepted",
    proposal_cov_scale: float = 1.4142135623730951,
    laplace_maxiter: int = 100,
    max_proposals: int | None = None,
    laplace_fits: LaplaceFit | None = None,
) -> LanesResult:
    """L chains of the K = 1 body as lanes of one loop: lane i is
    `metropolis(logpost_i, starts[i], keys[i], ...)` at speculative=0.

    logpost_lanes(zs (L, dim)) returns `.val` and `.beta` of shape (L,),
    lane i's at zs[i] (`models.likelihood.make_logpost_lanes`); its
    `lane(i)` gives lane i's own log-posterior for the Laplace fit and the
    start value. Without `lane`, logpost_lanes is one log-posterior that
    takes a batch (`make_logpost` on shared data) and serves every lane.
    laplace_fits (fields with a lane axis) resumes each lane from `starts`
    with its saved fit, as `metropolis(laplace_fit=)` does.

    Each lane has its own Laplace fit (a serial BFGS per lane) and
    proposal Cholesky. Its state (z, log-posterior, record rows and record
    count) lives on the device. A lane that hits a cap or a Geweke stop is
    frozen: it writes no record row, and its counters stop. The random
    stream does not depend on accept decisions, so every lane's draws are
    made LANES_DRAW_ROUNDS rounds ahead by one `chunk_draws_lanes` call, and
    the active lanes, which all step every round, consume them one round
    per iteration: lane i's round j takes the draws of its serial chain's
    round j. Each round reads back one flag per lane; the Geweke test runs
    on the host, for the lanes whose record count reaches a check
    boundary, on their windows read back together."""
    if record not in ("accepted", "all"):
        raise ValueError(record)
    if starts.ndim != 2 or keys.shape != (starts.shape[0], 2):
        raise ValueError("metropolis_lanes needs starts (L, dim) and keys "
                         "(L, 2)")
    n_lanes, dim = starts.shape
    dtype, dev = starts.dtype, starts.device
    if max_proposals is None:
        max_proposals = 50 * n_max
    lane_lp = _lane_logposts(logpost_lanes)
    if laplace_fits is None:
        laplace_fits = laplace_lanes(logpost_lanes, starts, laplace_maxiter)
        z0 = laplace_fits.mode
    else:
        z0 = starts
    chols, lpv0, lpb0 = [], [], []
    with torch.no_grad():
        for i in range(n_lanes):
            chols.append(torch.linalg.cholesky(proposal_cov_scale
                                               * laplace_fits.cov[i]))
            out0 = lane_lp(i)(z0[i])
            lpv0.append(out0.val)
            lpb0.append(out0.beta)
        return _lanes_loop(logpost_lanes, laplace_fits, z0,
                           torch.stack(chols), torch.stack(lpv0),
                           torch.stack(lpb0), keys.to(dev), n_max, samp_size,
                           batch_size, alpha_geweke, record, max_proposals,
                           LANES_DRAW_ROUNDS, dim, dtype, dev)


def _lane_logposts(logpost_lanes):
    """i -> lane i's own log-posterior: `logpost_lanes.lane(i)`, or the
    shared batch-capable log-posterior itself."""
    lane = getattr(logpost_lanes, "lane", None)
    return (lambda i: logpost_lanes) if lane is None else lane


def laplace_lanes(logpost_lanes, starts: torch.Tensor,
                  maxiter: int = 100) -> LaplaceFit:
    """Each lane's Laplace fit from starts[i] on its own log-posterior (a
    serial BFGS per lane), stacked: mode (L, dim), cov (L, dim, dim),
    logpost (L,)."""
    lane_lp = _lane_logposts(logpost_lanes)
    fits = []
    for i in range(starts.shape[0]):
        lp_i = lane_lp(i)
        fits.append(laplace(lambda z: lp_i(z).val, starts[i],
                            maxiter=maxiter))
    return LaplaceFit(*(torch.stack([torch.as_tensor(f[j]).detach()
                                     for f in fits]) for j in range(3)))


@trace.span("sampler")
def _lanes_loop(logpost_lanes, fits, z, prop_chol, lpv, lpb, keys, n_max,
                samp_size, batch_size, alpha_geweke, record, max_proposals,
                rr, dim, dtype, dev) -> LanesResult:
    n_lanes = z.shape[0]
    # one packed row [z | beta | logpost] per record and lane, plus a
    # scratch row n_max that frozen lanes write
    P = torch.zeros((n_lanes, n_max + 1, dim + 2), dtype=dtype, device=dev)
    lanes = torch.arange(n_lanes, device=dev)
    k_rec_d = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    k_rec = np.zeros(n_lanes, np.int64)
    n_prop = np.zeros(n_lanes, np.int64)
    n_acc = np.zeros(n_lanes, np.int64)
    pv = np.zeros(n_lanes, np.float64)
    active = np.ones(n_lanes, bool) if (n_max > 0 and max_proposals > 0) \
        else np.zeros(n_lanes, bool)
    active_d = torch.as_tensor(active, device=dev)
    every = record == "all"
    j = rr
    while active.any():
        if j == rr:
            keys, eps_c, log_u_c = rng.chunk_draws_lanes(keys, rr, 1, dim,
                                                         dtype)
            j = 0
        cand = z + (prop_chol @ eps_c[:, j, 0, :, None])[..., 0]
        out = logpost_lanes(cand)
        accept = (out.val - lpv) > log_u_c[:, j, 0]
        step = accept & active_d
        z = torch.where(step[:, None], cand, z)
        lpv = torch.where(step, out.val, lpv)
        lpb = torch.where(step, out.beta, lpb)
        P[lanes, torch.where(active_d, k_rec_d, n_max)] = torch.cat(
            [z, lpb[:, None], lpv[:, None]], dim=1)
        k_rec_d += active_d if every else step
        j += 1
        # the round's one read-back
        acc = trace.readback(accept).numpy() & active
        rec = active if every else acc
        k_rec += rec
        n_acc += acc
        n_prop += active
        check = np.flatnonzero(rec & (k_rec >= samp_size)
                               & (k_rec % batch_size == 0))
        if check.size:
            with trace.span("geweke"):
                rows = (torch.as_tensor(k_rec[check] - samp_size)[:, None]
                        + torch.arange(samp_size))
                windows = trace.readback(
                    P[torch.as_tensor(check, device=dev)[:, None],
                      rows.to(dev), :dim])
                for c, w in zip(check, windows):
                    pv[c] = float(geweke_pvalue(w))
        stop = active & ~((k_rec < n_max) & (pv < alpha_geweke)
                          & (n_prop < max_proposals))
        if stop.any():
            active &= ~stop
            active_d = torch.as_tensor(active, device=dev)
    trace.count("rounds.kept", int(n_prop.sum()))
    recorded = (torch.arange(n_max, device=dev)[None, :]
                < torch.as_tensor(k_rec, device=dev)[:, None])
    return LanesResult(
        samples=P[:, :n_max, :dim], betas=P[:, :n_max, dim],
        logposts=torch.where(recorded, P[:, :n_max, dim + 1],
                             torch.full_like(P[:, :n_max, dim + 1],
                                             -math.inf)),
        n_recorded=k_rec, n_proposals=n_prop, n_accepted=n_acc, pvalue=pv,
        converged=pv >= alpha_geweke, laplace=fits, n_rounds=n_prop.copy())
