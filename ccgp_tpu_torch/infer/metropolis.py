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
split(key, 3)`, then `normal(k1, (K, dim))` and `log(uniform(k2, (K,)))`):

* the K = 1 body (`speculative` <= 1, `body` in JAX): one proposal per
  round through `logpost`;
* the one-round speculative bodies (K > 1): `body_spec` evaluates the K
  candidates with `logpost_batch` (or `logpost` on the batch) and takes
  the first acceptance; `body_mh` hands the whole round to `mh_round`
  (`models.likelihood.make_mh_round`, one launch of the fused round
  kernel for SE/SE);
* the chunked driver (`mh_rounds`, K > 1, record="accepted"): each loop
  iteration runs a CHUNK of rounds through `mh_rounds` (one launch of the
  fused rounds kernel on the card), with the chunk's keys from
  `ops.rng.threefry_split_chain`. Three phases batch the SAME rounds:
  check-free 120-round warm chunks while no Geweke boundary is reachable,
  check-free 20-round chunks, then the check-aware tail. Caps and the
  Geweke stop truncate a chunk to the prefix of rounds that the one-round
  sampler would have run, so the chain is draw-for-draw the sequential
  one.

The loop conditions live on the host: a one-round body reads its
acceptance back once per round, a chunk its acc/consumed flags once per
chunk. The Geweke statistic (a few hundred scalar operations) runs on the
host copy of its window.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ccgp_tpu_torch.infer.geweke import geweke_pvalue
from ccgp_tpu_torch.infer.laplace import LaplaceFit, laplace
from ccgp_tpu_torch.models.likelihood import first_acceptance
from ccgp_tpu_torch.ops import rng

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
        ch = rng.split(key, 3)
        key, k1, k2 = ch[0], ch[1], ch[2]
        if K == 1:
            cand = z + prop_chol @ rng.normal(k1, (dim,), dtype)
            lp_c = logpost(cand)
            log_u = torch.log(rng.uniform(k2, (), dtype))
            accept = (lp_c.val - lpv) > log_u
            z = torch.where(accept, cand, z)
            lpv = torch.where(accept, lp_c.val, lpv)
            lpb = torch.where(accept, lp_c.beta, lpb)
            consumed = 1
        else:
            cands = z[None, :] + rng.normal(k1, (K, dim), dtype) @ prop_chol.T
            log_u = torch.log(rng.uniform(k2, (K,), dtype))
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
        acc_h = bool(accept)
        rec = acc_h or record == "all"
        k_rec += int(rec)
        n_acc += int(acc_h)
        n_prop += int(consumed)
        n_rnd += 1
        if rec and k_rec >= samp_size and k_rec % batch_size == 0:
            pv = float(geweke_pvalue(P[k_rec - samp_size:k_rec, :dim].cpu()))
    recorded = torch.arange(n_max, device=dev) < k_rec
    return MetropolisResult(
        samples=P[:, :dim], betas=P[:, dim],
        logposts=torch.where(recorded, P[:, dim + 1],
                             torch.full_like(P[:, dim + 1], -math.inf)),
        n_recorded=k_rec, n_proposals=n_prop, n_accepted=n_acc, pvalue=pv,
        converged=pv >= alpha_geweke, laplace=fit,
        n_rounds=n_rnd if K > 1 else n_prop)


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
        key, k1s, k2s = rng.threefry_split_chain(s["key"], rr)
        eps = rng.normal(k1s, (K, dim), dtype)               # (rr, K, dim)
        log_u = torch.log(rng.uniform(k2s, (K,), dtype))     # (rr, K)
        deltas = eps.reshape(rr * K, dim) @ prop_chol.T
        out = mh_rounds(s["z"], s["lpv"], s["lpb"], deltas, log_u)
        flags = torch.stack([out["acc"].to(torch.int64),
                             out["consumed"].to(torch.int64)]).cpu()
        acc, con = flags[0], flags[1]
        k_rec, n_prop = s["k_rec"], s["n_prop"]
        cum_acc = torch.cumsum(acc, 0)
        cum_con = torch.cumsum(con, 0)
        # a round ran iff every cap held before it: always a prefix
        runnable = (((n_prop + cum_con - con) < max_proposals)
                    & ((k_rec + cum_acc - acc) < n_max))
        pos = k_rec + cum_acc
        # accepted rows first (stable), landed as one slab at k_rec; rows
        # past the valid prefix are scratch that later chunks overwrite
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
                first_chk = int(torch.argmax(check_round.to(torch.int64)))
                pos_chk = int(pos[first_chk])
                window = P[pos_chk - samp_size:pos_chk, :dim].cpu()
                s["pv"] = float(geweke_pvalue(window))
                if s["pv"] >= alpha_geweke:
                    valid = runnable & (idx <= first_chk)
        n_acc_c = int(torch.sum(torch.where(valid, acc, 0)))
        s["k_rec"] += n_acc_c
        s["n_acc"] += n_acc_c
        s["n_prop"] += int(torch.sum(torch.where(valid, con, 0)))
        s["n_rnd"] += int(torch.sum(valid))
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
