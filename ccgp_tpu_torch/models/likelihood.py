"""Transformed log-posterior of the combined GP (port of
`ccgp_tpu/models/likelihood.py`).

    beta_hat = 1'R^-1 y / 1'R^-1 1
    loglike  = dmnorm(y; beta 1, (p^2 + (1-p)^2) sigma2 R)
    logpost  = loglike + log-Jacobian + log-prior

A singular R gives NaN, and a NaN or infinite log-posterior becomes -inf:
the sampler rejects it. No exception is raised.

whiten=True computes the quadratic (y - beta 1)' R^-1 (y - beta 1) by
whitening the centred residual with one more triangular solve, instead of
the bordered identity qyy - qoy^2 / qoo, whose two large near-equal sums
cancel in float32 at n >= 768 when y is far from centred
(`scripts/verify_whiten_oracle.py`). Like JAX
(`ccgp_tpu/models/likelihood.py:273-276,421-423`), it opts out of every
fused kernel (K1, K6, K7), whose factorization cores accumulate the
bordered sums: the batched evaluator factors explicitly, and the rounds
run as a loop over it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ccgp_tpu_torch.models.combination import (
    MixtureSpec, MixParams, _effective_rates, mixed_gram, mix_weights, unpack)
from ccgp_tpu_torch.ops import linalg
from ccgp_tpu_torch.ops.chol import chol_quadratics
from ccgp_tpu_torch.ops.chol_smallk import (
    CandModel, PRIOR_NONE, dispatch_ok, fused_mix_mh_round,
    fused_mix_mh_rounds, fused_mix_quadratics_smallk)

_LOG2PI = math.log(2.0 * math.pi)


class LogPost(NamedTuple):
    """Value and per-evaluation byproducts."""

    val: torch.Tensor      # log-posterior (-inf == invalid proposal)
    beta: torch.Tensor     # GLS intercept at these parameters
    chol: torch.Tensor     # lower Cholesky of R_mix
    params: MixParams      # constrained parameters


def is_se_mix(spec: MixtureSpec) -> bool:
    """Both components squared exponential (the fused kernels' mixture)."""
    return (spec.kernel1.raw_kind == "sqdist"
            and spec.kernel2.raw_kind == "sqdist")


def _log_prior(spec, params, theta1_prior, theta2_prior, p_prior, like):
    log_prior = torch.zeros_like(like)
    if theta1_prior is not None:
        lp1 = theta1_prior.log_kernel(params.theta1)
        log_prior = log_prior + (torch.sum(lp1, dim=-1)
                                 if spec.anisotropic else lp1)
    if theta2_prior is not None:
        log_prior = log_prior + theta2_prior.log_kernel(params.theta2)
    if p_prior is not None:
        log_prior = log_prior + p_prior.log_kernel(params.p)
    return log_prior


def _fused_gate(spec: MixtureSpec, n: int, kk: int) -> bool:
    """JAX's gate for the fused one-round kernels (K6, K7): an SE/SE
    mixture with n <= 256 and K <= 16 (`likelihood.py:177-178,276-277`),
    taken here on every device."""
    return is_se_mix(spec) and n <= 256 and kk <= 16


def _rate_rows(spec: MixtureSpec, params: MixParams, kk: int, d: int):
    """The training rates (K, d) of both components (an isotropic rate
    repeated over the d axes), as the fused kernels take them."""
    th1, th2 = _effective_rates(spec, params, predict=False)
    return (torch.broadcast_to(th1.reshape(kk, -1), (kk, d)),
            torch.broadcast_to(th2.reshape(kk, -1), (kk, d)))


def _finite_or_neg_inf(val: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(val), val,
                       torch.full_like(val, -math.inf))


def whitened_quadratics(r: torch.Tensor, y: torch.Tensor, jitter=0.0):
    """(logdet, beta, quad) of a batch of Grams r (K, n, n) by whitening:
    one `cholesky_ex`, the solves of y and 1 for beta = 1'R^-1 y /
    1'R^-1 1, then a third solve of the residual y - beta centred before
    it is whitened (`wy - beta wo` would lose the digits whiten keeps);
    quad = |L^-1 (y - beta)|^2."""
    kk, n = r.shape[0], r.shape[-1]
    chol = linalg.jitter_cholesky(r, jitter)
    wy = linalg.tri_solve(chol, torch.broadcast_to(y, (kk, n)))
    wo = linalg.tri_solve(chol, torch.ones((kk, n), dtype=y.dtype,
                                           device=y.device))
    beta = torch.sum(wo * wy, dim=-1) / torch.sum(wo * wo, dim=-1)
    w = linalg.tri_solve(chol, y[None, :] - beta[:, None])
    return linalg.chol_logdet(chol), beta, torch.sum(w * w, dim=-1)


def make_logpost(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                 sigma2, theta1_prior=None, theta2_prior=None, p_prior=None,
                 jitter: float = 0.0, whiten: bool = False):
    """logpost(z) -> LogPost for unconstrained z (differentiable: Laplace
    takes its gradient and Hessian). One bordered factorization gives the
    factor, logdet and every quadratic form; whiten=True adds the solve of
    the centred residual y - beta for the quadratic. `logpost.to(device)`
    is the same log-posterior on x, y and sigma2 moved to `device` (a
    mesh of distinct devices runs a shard on each)."""
    n = y.shape[-1]

    def logpost(z: torch.Tensor) -> LogPost:
        params, log_jac = unpack(spec, z)
        r = mixed_gram(spec, x, params)
        q = linalg.bordered_cholesky_quadratics(r, y, jitter)
        beta = q["qoy"] / q["qoo"]
        if whiten:
            w = linalg.tri_solve(q["chol"], y - beta[..., None])
            quad = torch.sum(w * w, dim=-1)
        else:
            quad = q["qyy"] - q["qoy"] ** 2 / q["qoo"]
        _, _, s = mix_weights(params.p)
        log_scale = torch.log(s * sigma2)
        loglike = -0.5 * (n * _LOG2PI + q["logdet"] + n * log_scale
                          + quad * torch.exp(-log_scale))
        val = loglike + log_jac + _log_prior(
            spec, params, theta1_prior, theta2_prior, p_prior, loglike)
        return LogPost(val=_finite_or_neg_inf(val), beta=beta,
                       chol=q["chol"], params=params)

    def to(device):
        s2 = sigma2.to(device) if isinstance(sigma2, torch.Tensor) else sigma2
        return make_logpost(spec, x.to(device), y.to(device), s2,
                            theta1_prior=theta1_prior,
                            theta2_prior=theta2_prior, p_prior=p_prior,
                            jitter=jitter, whiten=whiten)

    logpost.to = to
    return logpost


class LanesLogPost:
    """The log-posteriors of L designs as lanes of one batch: called on
    zs (L, dim), lane i evaluated at zs[i] on its own xs[i], ys[i] and
    sigma2[i], it returns a LogPost whose fields carry the lane axis
    (`.val`, `.beta` (L,)). `lane(i)` is lane i's own `make_logpost`
    closure (the Laplace fit and the start state take it)."""

    def __init__(self, spec, xs, ys, sigma2, **kw):
        self.spec, self.xs, self.ys, self.sigma2, self._kw = (
            spec, xs, ys, sigma2, kw)
        self._batch = make_logpost(spec, xs, ys, sigma2, **kw)

    def __call__(self, zs: torch.Tensor) -> LogPost:
        return self._batch(zs)

    def lane(self, i: int):
        return make_logpost(self.spec, self.xs[i], self.ys[i],
                            self.sigma2[i], **self._kw)


def make_logpost_lanes(spec: MixtureSpec, xs: torch.Tensor, ys: torch.Tensor,
                       sigma2, theta1_prior=None, theta2_prior=None,
                       p_prior=None, jitter: float = 0.0,
                       whiten: bool = False) -> LanesLogPost:
    """`jax.vmap` of `make_logpost` over designs: xs (L, n, d), ys (L, n),
    sigma2 (L,) (a scalar is repeated). The L Grams go through the same
    bordered factorization as `make_logpost`'s, as one (L, n + 2, n + 2)
    batch, so lane i equals `make_logpost` on design i; like the JAX
    vmap, it reaches no kernel."""
    if xs.ndim != 3 or ys.shape != xs.shape[:2]:
        raise ValueError(f"make_logpost_lanes needs xs (L, n, d) and ys "
                         f"(L, n); got {tuple(xs.shape)}, {tuple(ys.shape)}")
    sigma2 = torch.as_tensor(sigma2, dtype=ys.dtype, device=ys.device)
    sigma2 = torch.broadcast_to(sigma2, ys.shape[:1])
    return LanesLogPost(spec, xs, ys, sigma2, theta1_prior=theta1_prior,
                        theta2_prior=theta2_prior, p_prior=p_prior,
                        jitter=jitter, whiten=whiten)


def make_logpost_batch(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                       sigma2, theta1_prior=None, theta2_prior=None,
                       p_prior=None, jitter: float = 0.0,
                       whiten: bool = False):
    """f(Z (K, dim)) -> (vals (K,), betas (K,)). An SE/SE mixture with
    n <= 256 and K <= 16 builds its Grams inside the fused quadratics
    kernel (`fused_mix_quadratics_smallk`, K6); every other mixture builds
    them with `mixed_gram` and sends the K factorizations through
    `chol_quadratics` as one batch (K <= 16: the small-K kernel K5), as
    JAX routes them on a TPU. R_mix has a unit diagonal, so the absolute
    jitter here equals `make_logpost`'s mean-diagonal-relative one.

    whiten=True takes no kernel: `whitened_quadratics`."""
    n = y.shape[-1]
    n_dim = x.shape[-1]

    def logpost_batch(zs: torch.Tensor):
        params, log_jac = unpack(spec, zs)
        kk = zs.shape[0]
        if whiten:
            logdet, beta, quad = whitened_quadratics(
                mixed_gram(spec, x, params), y, jitter)
        else:
            if _fused_gate(spec, x.shape[-2], kk):
                r1, r2 = _rate_rows(spec, params, kk, n_dim)
                q = fused_mix_quadratics_smallk(x, y, r1, r2, params.p,
                                                jitter=jitter)
            else:
                r = mixed_gram(spec, x, params)            # (K, n, n)
                q = chol_quadratics(r, y, jitter=jitter)
            beta = q["qoy"] / q["qoo"]
            quad = q["qyy"] - q["qoy"] ** 2 / q["qoo"]
            logdet = q["logdet"]
        _, _, s = mix_weights(params.p)
        log_scale = torch.log(s * sigma2)
        loglike = -0.5 * (n * _LOG2PI + logdet + n * log_scale
                          + quad * torch.exp(-log_scale))
        val = loglike + log_jac + _log_prior(
            spec, params, theta1_prior, theta2_prior, p_prior, loglike)
        return _finite_or_neg_inf(val), beta

    return logpost_batch


def _prior_triple(prior):
    if prior is None:
        return (PRIOR_NONE, 0.0, 0.0)
    return (prior.code, *prior.args)


def cand_model_for(spec: MixtureSpec, x: torch.Tensor, theta1_prior=None,
                   theta2_prior=None, p_prior=None) -> CandModel:
    """The fused kernel's parameter struct for this spec and these priors
    (the JAX kernel's `cand_model` closure)."""
    return CandModel.make(
        anisotropic=spec.anisotropic, ndim=x.shape[-1],
        tied=spec.rough == "tied",
        priors=[_prior_triple(theta1_prior), _prior_triple(theta2_prior),
                _prior_triple(p_prior)])


def make_mh_round(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                  sigma2, theta1_prior=None, theta2_prior=None, p_prior=None,
                  jitter: float = 0.0, whiten: bool = False):
    """One whole speculative round per call: f(z, lp_val, lp_beta,
    cands (K, dim), log_u (K,)) -> (z_new, val_new, beta_new, any_acc,
    consumed) (port of `ccgp_tpu/models/likelihood.py:222-299`).

    An SE/SE mixture with n <= 256 and K <= 16 runs the round in the fused
    kernel (`fused_mix_mh_round`, K7): the candidates' transforms, priors
    and log-scales are computed here, the Grams, factorizations,
    log-posteriors and first-acceptance scan in the kernel. Otherwise, and
    always under whiten, the batched log-posterior (`make_logpost_batch`)
    and the same selection in PyTorch. The random stream and the Markov
    kernel are the same either way."""
    n_dim = x.shape[-1]
    lp_batch = make_logpost_batch(spec, x, y, sigma2,
                                  theta1_prior=theta1_prior,
                                  theta2_prior=theta2_prior,
                                  p_prior=p_prior, jitter=jitter,
                                  whiten=whiten)

    def mh_round(z, lp_val, lp_beta, cands, log_u):
        kk = cands.shape[0]
        if not whiten and _fused_gate(spec, x.shape[-2], kk):
            params, log_jac = unpack(spec, cands)
            r1, r2 = _rate_rows(spec, params, kk, n_dim)
            extra = log_jac + _log_prior(spec, params, theta1_prior,
                                         theta2_prior, p_prior, log_jac)
            _, _, s = mix_weights(params.p)
            return fused_mix_mh_round(x, y, r1, r2, params.p, extra,
                                      torch.log(s * sigma2), cands, lp_val,
                                      lp_beta, log_u, jitter=jitter)
        vals, betas = lp_batch(cands)
        return first_acceptance(z, lp_val, lp_beta, cands, vals, betas,
                                 log_u)

    return mh_round


def first_acceptance(z, lp_val, lp_beta, cands, vals, betas, log_u):
    """A speculative round's selection (`body_spec` in JAX): the first
    candidate whose log-posterior beats its threshold, else the current
    state. Returns (z_new, val_new, beta_new, any_acc, consumed)."""
    kk = cands.shape[0]
    acc = (vals - lp_val) > log_u
    any_acc = acc.any()
    first = torch.argmax(acc.to(torch.int32))
    consumed = torch.where(any_acc, first + 1, kk).to(torch.int32)
    return (torch.where(any_acc, cands[first], z),
            torch.where(any_acc, vals[first], lp_val),
            torch.where(any_acc, betas[first], lp_beta), any_acc, consumed)


def make_mh_rounds(spec: MixtureSpec, x: torch.Tensor, y: torch.Tensor,
                   sigma2, theta1_prior=None, theta2_prior=None,
                   p_prior=None, jitter: float = 0.0, stash: bool = False,
                   whiten: bool = False):
    """R whole speculative rounds per call: f(z, lp_val, lp_beta,
    deltas (R*K, dim), log_u (R, K)) -> dict (see
    `ops.chol_smallk.fused_mix_mh_rounds`).

    SE/SE mixtures inside `dispatch_ok(n, K)` take the fused rounds
    function on every device (the CUDA kernel for CUDA tensors, its plain
    twin for CPU tensors), which also emits the stash. Every other mixture
    and shape, and whiten=True, runs the same chain as a loop of
    `make_logpost_batch` evaluations without a stash, as JAX routes it."""
    n = x.shape[-2]
    fused = is_se_mix(spec) and not whiten
    model = (cand_model_for(spec, x, theta1_prior, theta2_prior, p_prior)
             if fused else None)
    lp_batch = make_logpost_batch(spec, x, y, sigma2,
                                  theta1_prior=theta1_prior,
                                  theta2_prior=theta2_prior,
                                  p_prior=p_prior, jitter=jitter,
                                  whiten=whiten)

    def mh_rounds(z, lp_val, lp_beta, deltas, log_u):
        rr, kk = log_u.shape
        if fused and dispatch_ok(n, kk):
            return fused_mix_mh_rounds(x, y, z, lp_val, lp_beta, sigma2,
                                       deltas, log_u, model, jitter=jitter,
                                       stash=stash)
        if stash:
            raise ValueError(
                f"make_mh_rounds(stash=True) requires the fused rounds "
                f"(an SE/SE mixture without whiten, dispatch_ok envelope: "
                f"n <= 1024, K <= 16); got n={n}, K={kk}, whiten={whiten}")
        zc, lpv, lpb = z, lp_val, lp_beta
        dl = deltas.reshape(rr, kk, -1)
        rows, accs, cons = [], [], []
        for r in range(rr):
            cands = zc[None, :] + dl[r]
            vals, betas = lp_batch(cands)
            zc, lpv, lpb, any_acc, consumed = first_acceptance(
                zc, lpv, lpb, cands, vals, betas, log_u[r])
            rows.append(torch.cat([zc, lpb.reshape(1), lpv.reshape(1)]))
            accs.append(any_acc)
            cons.append(consumed)
        return {"rec": torch.stack(rows), "acc": torch.stack(accs),
                "consumed": torch.stack(cons), "z_fin": zc,
                "val_fin": lpv, "beta_fin": lpb}

    return mh_rounds
