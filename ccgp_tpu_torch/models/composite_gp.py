"""Composite Gaussian process (Ba & Joseph 2012), the reference's second
competitor baseline (port of `ccgp_tpu/models/composite_gp.py`, itself a
re-derivation of the reference's `CGP` / `predict.CGP`, `1D Codes and
Designs/1D Combined GP Public.R:62-321`). A global smooth GP plus a local
rough GP whose variance varies over space:

    Q(w) = G(theta) + lambda sqrt(S) L(alpha) sqrt(S),  alpha = kappa + theta
    S    = local variances re-estimated from smoothed squared residuals
           (bandwidth bw) over 4 fixed-point iterations
    objective(w) = log det Q + n log tau2(w),  w = (lambda, theta, kappa, bw)

The fit: 505 midpoint-LHD candidates scored as ONE batch, the best
`num_starts` (ties to the lower index, as `jax.lax.top_k`) refined by
box-constrained BFGS (`infer.optim.multistart_minimize`), then, unless
jackknife=False, the n leave-one-out refits as one batch (the jackknife
RMSCV; NaN without it) and the predictor
with local-variance weighting and +/-1.96 sigma intervals. Every helper
takes leading batch axes. A failed factorization is NaN
(`linalg.jitter_cholesky`), and a non-finite objective scores 1e6.

The fit runs as the span `cgp`: `cgp/candidates` (counting
`cgp.candidates`), the searches' `cgp/bfgs` and `cgp/jackknife` (counting
`cgp.jackknife_refits`); the predictor as `cgp_predict`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ccgp_tpu_torch.infer.optim import multistart_minimize
from ccgp_tpu_torch.ops import linalg, rng
from ccgp_tpu_torch.ops.distance import cross_sqdist, pairwise_sqdist
from ccgp_tpu_torch.utils import trace

# the reference's defaults: the nugget ratio's and the global rates' lower
# bounds, and the number of candidates refined by BFGS
NUGGET_L = 0.001
THETA_L = 1e-4
NUM_STARTS = 5


class CGPFit(NamedTuple):
    x: torch.Tensor            # original-scale design (n, p)
    y: torch.Tensor            # (n,)
    lam: torch.Tensor          # nugget ratio lambda
    theta: torch.Tensor        # (p,) global rates (original scale)
    alpha: torch.Tensor        # (p,) local rates (original scale)
    bandwidth: torch.Tensor    # bw
    sig: torch.Tensor          # (n,) normalized local variances (diag of S)
    sf: torch.Tensor           # normalizing factor mean(diag S)
    res2: torch.Tensor         # (n,) squared residuals at the fit
    temp: torch.Tensor         # (n,) Q^-1 (y - beta 1)
    invq_chol: torch.Tensor    # (n, n) Cholesky of Q
    beta: torch.Tensor
    tau2: torch.Tensor
    objval: torch.Tensor
    rmscv: torch.Tensor        # leave-one-out RMS cross-validation error


class CGPPrediction(NamedTuple):
    mean: torch.Tensor         # Yp: composite prediction
    global_mean: torch.Tensor  # gp: global-component prediction
    local_var: torch.Tensor    # v(x)
    lower: torch.Tensor
    upper: torch.Tensor


def _se_gram(x, rates):
    """SE Gram with an exact unit diagonal: x (..., n, p), rates (..., p)."""
    g = torch.exp(-pairwise_sqdist(x, rates))
    eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    return g * (1.0 - eye) + eye


def _vdot(a, b):
    """sum over the last axis of a * b."""
    return torch.sum(a * b, dim=-1)


def _mv(m, v):
    """m (..., n, k) @ v (..., k) -> (..., n)."""
    return (m @ v[..., None])[..., 0]


def _q(g, lam, l, sig):
    """Q = G + lambda sqrt(S) L sqrt(S) for S = diag(sig)."""
    rs = torch.sqrt(sig)
    return g + lam[..., None, None] * (rs[..., :, None] * l
                                       * rs[..., None, :])


def _gls(chol, y):
    """beta = <u, w> / <u, u>, u = L^-1 1, w = L^-1 y."""
    u = linalg.tri_solve(chol, torch.ones_like(y))
    w = linalg.tri_solve(chol, y)
    return _vdot(u, w) / _vdot(u, u)


def _sigma_iterations(g, l, gbw, lam, y, n_iter: int = 4):
    """The reference's fixed-point local-variance loop (`:116-127`), from
    S = I. Returns (sig, sf, beta, e) of the last round."""
    y = torch.broadcast_to(y, g.shape[:-1])
    ones = torch.ones_like(y)
    sig = ones
    for _ in range(n_iter):
        chol = linalg.jitter_cholesky(_q(g, lam, l, sig))
        beta = _gls(chol, y)
        temp = linalg.chol_solve(chol, y - beta[..., None])
        e = y - (beta[..., None] + _mv(g, temp))
        sig_new = _mv(gbw, e * e) / _mv(gbw, ones)
        sf = torch.mean(sig_new, dim=-1)
        sig = sig_new / sf[..., None]
    return sig, sf, beta, e


def _split_w(w, p):
    return w[..., 0], w[..., 1:p + 1], w[..., p + 1], w[..., p + 2]


def _factor(x, y, theta, alpha, lam, bw):
    """Q at the given rates after the local-variance iterations: (sig, sf,
    e, chol, beta, y broadcast to the batch)."""
    g = _se_gram(x, theta)
    l = _se_gram(x, alpha)
    gbw = _se_gram(x, theta * bw[..., None])
    sig, sf, _, e = _sigma_iterations(g, l, gbw, lam, y)
    y = torch.broadcast_to(y, g.shape[:-1])
    chol = linalg.jitter_cholesky(_q(g, lam, l, sig))
    return sig, sf, e, chol, _gls(chol, y), y


def _objective(w, x_std, y):
    """var.MLE.DK (`:106-137`) at w (..., p + 3) = (lambda, theta_1..p,
    kappa, bw): log det Q + n log tau2, 1e6 where not finite."""
    n, p = x_std.shape
    lam, theta, kappa, bw = _split_w(w, p)
    _, _, _, chol, beta, y = _factor(x_std, y, theta, kappa[..., None] + theta,
                                     lam, bw)
    r = linalg.tri_solve(chol, y - beta[..., None])
    tau2 = _vdot(r, r) / n
    val = linalg.chol_logdet(chol) + n * torch.log(tau2)
    return torch.where(torch.isfinite(val), val, torch.full_like(val, 1e6))


def _standardize(x):
    lo = torch.amin(x, dim=0)
    scales = torch.amax(x, dim=0) - lo
    return (x - lo) / scales, scales


def _bounds(x_std, p, nugget_l=NUGGET_L, theta_l=None, alpha_l=None,
            kappa_u=None, dtype=None):
    """The hyperparameter box from the data scale (`:81-93`): lambda in
    [nugget_l, 1], theta in [theta_l, alpha_l], kappa in [alpha_l,
    kappa_u], bw in [0, 1]. None takes the reference's default: theta_l
    THETA_L, alpha_l log(10^2) and kappa_u log(10^6) times the mean inverse
    squared distance of the standardized design. alpha_l and kappa_u may
    be arrays, as in JAX (the box then has their lengths). dtype None is
    x_std's."""
    dtype = x_std.dtype if dtype is None else dtype
    dev = x_std.device
    n = x_std.shape[0]
    iu = torch.triu_indices(n, n, 1, device=dev)
    mean_inv_d2 = torch.mean(1.0 / pairwise_sqdist(x_std)[iu[0], iu[1]])
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)  # noqa: E731
    if theta_l is None:
        theta_l = THETA_L
    alpha_l = (math.log(10.0 ** 2) * mean_inv_d2 if alpha_l is None
               else t(alpha_l))
    if kappa_u is None:
        kappa_u = math.log(10.0 ** 6) * mean_inv_d2
    lower = torch.cat([t([nugget_l]), torch.broadcast_to(t(theta_l), (p,)),
                       torch.atleast_1d(t(alpha_l)), t([0.0])])
    upper = torch.cat([t([1.0]), torch.ones(p, dtype=dtype, device=dev)
                       * alpha_l, torch.atleast_1d(t(kappa_u)), t([1.0])])
    return lower, upper


def _lhd(key, n, k, dtype):
    """Midpoint Latin hypercube (the reference's `LHD`, `:141-146`): each
    column a `rng.permutation` of (i + 0.5) / n."""
    dev = key.device
    base = ((torch.arange(n, dtype=dtype, device=dev) + 0.5)
            / torch.tensor(n, dtype=dtype, device=dev))
    return torch.stack([rng.permutation(kj, base)
                        for kj in rng.split(key, k)], dim=1)


@trace.span("cgp")
def cgp_fit(x: torch.Tensor, y: torch.Tensor, key: torch.Tensor,
            nugget_l: float = NUGGET_L, num_starts: int = NUM_STARTS,
            theta_l=None, alpha_l=None, kappa_u=None,
            n_candidates: int = 505, jackknife: bool = True) -> CGPFit:
    """Fit the composite GP to x (n, p), y (n,) on their device; the key
    draws the candidate LHD. The box is `_bounds`'s (None takes the
    reference's defaults); jackknife=False skips the leave-one-out refits
    and leaves rmscv NaN."""
    n, p = x.shape
    dt, dev = x.dtype, x.device
    y = y.to(dtype=dt, device=dev)
    x_std, scales = _standardize(x)
    lower, upper = _bounds(x_std, p, nugget_l, theta_l, alpha_l, kappa_u, dt)

    def obj(w):
        return _objective(w, x_std, y)

    # 1) the candidate sweep as one batch; the best num_starts, ties to the
    # lower index as jax.lax.top_k(-objective)
    with trace.span("candidates"):
        trace.count("cgp.candidates", n_candidates)
        cand = (_lhd(key.to(dev), n_candidates, p + 3, dt) * (upper - lower)
                + lower)
        with torch.no_grad():
            cand_obj = obj(cand)
        top = cand[torch.sort(-cand_obj, descending=True, stable=True)[1]
                   [:num_starts]]

    # 2) bounded refinement of the top starts
    res = multistart_minimize(obj, top, lower=lower, upper=upper)
    w_opt, objval = res.x, res.fun
    lam, theta_std, kappa, bwv = _split_w(w_opt, p)
    theta = theta_std / scales ** 2
    alpha = (kappa + theta_std) / scales ** 2

    # 3) the final assembly at the optimum (original-scale kernels)
    with torch.no_grad():
        sig, sf, e, chol, beta, _ = _factor(x, y, theta, alpha, lam, bwv)
        temp = linalg.chol_solve(chol, y - beta)
        tau2 = _vdot(y - beta, temp) / n
        rmscv = (_jackknife(x, y, theta, alpha, lam, bwv) if jackknife
                 else torch.tensor(math.nan, dtype=dt, device=dev))
    return CGPFit(x=x, y=y, lam=lam.detach(), theta=theta.detach(),
                  alpha=alpha.detach(), bandwidth=bwv.detach(), sig=sig,
                  sf=sf, res2=e * e, temp=temp, invq_chol=chol, beta=beta,
                  tau2=tau2, objval=objval, rmscv=rmscv)


@trace.span("jackknife")
def _jackknife(x, y, theta, alpha, lam, bwv):
    """The jackknife RMSCV (`:171-199`): the n leave-one-out refits at the
    fit's rates as one batch, each predicting its held-out point."""
    n, dev = x.shape[0], x.device
    trace.count("cgp.jackknife_refits", n)
    keep = torch.stack([torch.cat([torch.arange(j, device=dev),
                                   torch.arange(j + 1, n, device=dev)])
                        for j in range(n)])                  # (n, n - 1)
    xs, ys = x[keep], y[keep]
    sigj, sfj, ej, cholj, betaj, _ = _factor(xs, ys, theta, alpha, lam, bwv)
    tempj = linalg.chol_solve(cholj, ys - betaj[..., None])
    dj = (xs - x[:, None, :]) ** 2                           # (n, n - 1, p)
    gv = torch.exp(-torch.sum(theta * dj, dim=-1))
    lv = torch.exp(-torch.sum(alpha * dj, dim=-1))
    gbv = torch.exp(-torch.sum(theta * bwv * dj, dim=-1))
    vj = _vdot(gbv, ej * ej) / _vdot(gbv, torch.ones_like(ys)) / sfj
    qv = gv + lam * torch.sqrt(vj)[:, None] * torch.sqrt(sigj) * lv
    yjf = betaj + _vdot(qv, tempj)
    return torch.sqrt(torch.mean((y - yjf) ** 2))


@trace.span("cgp_predict")
def cgp_predict(fit: CGPFit, x_new: torch.Tensor,
                alpha_level: float = 0.05) -> CGPPrediction:
    """predict.CGP (`:249-321`) over all test points at once, with the
    reference's fixed +/-1.96 sigma intervals for any alpha_level: it is
    accepted, as in JAX, and the reference hard-codes 95%."""
    x, y = fit.x, fit.y
    x_new = x_new.to(dtype=x.dtype, device=x.device)
    ones = torch.ones_like(y)
    g = torch.exp(-cross_sqdist(x, x_new, fit.theta))          # (n, t)
    l = torch.exp(-cross_sqdist(x, x_new, fit.alpha))
    gbw = torch.exp(-cross_sqdist(x, x_new, fit.theta * fit.bandwidth))
    v = (gbw.T @ fit.res2) / (gbw.T @ ones) / fit.sf            # (t,)
    rs = torch.sqrt(fit.sig)
    q = g + fit.lam * torch.sqrt(v)[None, :] * (rs[:, None] * l)
    mean = fit.beta + q.T @ fit.temp
    gmean = fit.beta + g.T @ fit.temp
    w = linalg.tri_solve(fit.invq_chol, q)                      # (n, t)
    u = linalg.tri_solve(fit.invq_chol, ones)
    quad = torch.sum(w * w, dim=0)
    ppp = 1.0 + fit.lam * v - quad + (1.0 - u @ w) ** 2 / torch.sum(u * u)
    half = 1.96 * torch.sqrt(fit.tau2 * torch.clamp_min(ppp, 0.0))
    return CGPPrediction(mean=mean, global_mean=gmean, local_var=v,
                         lower=mean - half, upper=mean + half)
