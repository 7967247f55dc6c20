"""Plain reference of the ground-vibrations comparison study's two
baselines and its table (Harari & Steinberg 2014, `Ground Vibrations
Emulator/Combined GP Ground Vibrations.R:648-675`): mlegp's ARD GP, the
composite GP and `Comparison.Summary`. Plain PyTorch only: no kernel, no
import of the measured package or of JAX. The combined GP's part is
`reference/combined_gp.py`, whose factor and GLS solve (`_cholesky`,
`_gls`) this file uses too.

**mlegp's ARD GP** (Dancik's `mlegp`: the single-GP baseline, and its
sigma^2 the combined GP's plug-in). A constant mean and the Gaussian
correlation R_ij = exp(-sum_a rate_a (x_ia - x_ja)^2), rate = e^psi:

    beta     = 1'R^-1 y / 1'R^-1 1
    sigma2   = (y - beta 1)'R^-1 (y - beta 1) / n
    nll(psi) = log det R + n log sigma2; +inf where R's largest
               off-diagonal entry reaches 1 - 1e-6 (the all-ones ridge)
    mean(t)  = beta + r(t)'R^-1 (y - beta 1)
    se(t)    = sqrt(sigma2 (1 - r(t)'R^-1 r(t)))          (`se.fit`)
    interval = mean -/+ t_{n-1}(1 - alpha/2) se(t)

**The composite GP** (Ba & Joseph 2012, the R scripts' vendored `CGP`,
`var.MLE.DK` and `predict.CGP`, `1D Combined GP Public.R:62-321`). With
G(rates) the SE correlation, w = (lambda, theta_1..p, kappa, bw) on the
design scaled to [0, 1] per axis:

    G = G(theta), L = G(kappa + theta), B = G(bw theta), S = I
    4 times: Q = G + lambda S^1/2 L S^1/2, beta = GLS mean under Q,
             e = y - beta - G Q^-1 (y - beta),
             s = B e^2 / B 1, S = diag(s / mean(s))
    Q and beta at the last S, tau2 = (y - beta)'Q^-1 (y - beta) / n
    objective(w) = log det Q + n log tau2            (1e6 where not finite)

The box (`:81-93`): lambda in [1e-3, 1], theta in [1e-4, a], kappa in
[a, k], bw in [0, 1], a = log(10^2) m and k = log(10^6) m, m the mean of
1 / |x_i - x_j|^2 over the scaled design's pairs. On the original scale
the rates are theta / scale^2 and (kappa + theta) / scale^2. At the
optimum the same loop on the original design gives S (mean s the factor
sf), the residuals e, Q and beta; the jackknife (`:171-199`) refits
without point j at the same rates and predicts it, RMSCV the root mean
square of those errors; the predictor (`:249-321`) at t:

    v(t)  = b(t)'e^2 / b(t)'1 / sf,  q(t) = g(t) + lambda sqrt(v(t)) S^1/2 l(t)
    mean  = beta + q(t)'Q^-1 (y - beta)
    var   = tau2 (1 + lambda v(t) - q'Q^-1 q + (1 - 1'Q^-1 q)^2 / 1'Q^-1 1)
    interval = mean -/+ 1.96 sqrt(max(var, 0))   (95% whatever alpha)

**The table** (`Comparison.Summary`): per model the RMSPE over the test
points and the share of them inside the interval; the combined model's
mean calibration quantile.

Departures from R: `nll` is twice mlegp's negative log-likelihood less
its constant n (1 + log 2 pi), which moves no optimum. The searches are
a batched float64 BFGS with a backtracking line search (`descend`) in a
tanh map of the box, not mlegp's simplex-then-BFGS or `optim`'s L-BFGS-B;
they say how far an optimum can be lowered, they do not replay R's. The
t quantile is found by integrating the t density (`t_quantile`).
Distances are differences, not the |a|^2 + |b|^2 - 2 a.b expansion.
"""
from __future__ import annotations

import math

import torch

from reference import threefry
from reference.combined_gp import (F64, Precision, _cholesky, _gls, _solve,
                                   grid_search)

RIDGE = 1.0 - 1e-6


# -- shared pieces -----------------------------------------------------------

def sqdist(a: torch.Tensor, b: torch.Tensor, rates: torch.Tensor):
    """sum_k rate_k (a_ik - b_jk)^2: a (..., n, d), b (..., m, d), rates
    (..., d) -> (..., n, m), from the differences."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return (diff * diff * rates[..., None, None, :]).sum(-1)


def _like(v, x):
    """v as a tensor of x's dtype on x's device."""
    return torch.as_tensor(v).to(device=x.device, dtype=x.dtype)


def corr(a, b, rates):
    return torch.exp(-sqdist(a, b, rates))


def back_solve(chol, a):
    """L'^-1 a for a (..., n): (L L')^-1 b where a = L^-1 b."""
    return torch.linalg.solve_triangular(chol.transpose(-1, -2),
                                         a[..., None], upper=True)[..., 0]


def t_quantile(p: float, df: int) -> float:
    """The p quantile (p > 1/2) of Student's t with df degrees of freedom:
    the density integrated by Simpson's rule on a fine grid, the crossing
    found by bisection, in float64."""
    lg = (math.lgamma((df + 1) / 2) - math.lgamma(df / 2)
          - 0.5 * math.log(df * math.pi))

    def cdf(x: float) -> float:
        m = 20000
        s = torch.linspace(0.0, x, 2 * m + 1, dtype=torch.float64)
        f = torch.exp(lg - (df + 1) / 2 * torch.log1p(s * s / df))
        w = torch.ones(2 * m + 1, dtype=torch.float64)
        w[1:-1:2], w[2:-1:2] = 4.0, 2.0
        return 0.5 + float((w * f).sum()) * (x / (2 * m)) / 3.0

    lo, hi = 0.0, 1.0
    while cdf(hi) < p:
        lo, hi = hi, 2.0 * hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if cdf(mid) < p else (lo, mid)
    return 0.5 * (lo + hi)


def tanh_map(lower, upper):
    """(to_box, from_box): R^k -> (lower, upper)^k and back."""
    mid, half = 0.5 * (upper + lower), 0.5 * (upper - lower)

    def to_box(u):
        return mid + half * torch.tanh(u)

    def from_box(v):
        return torch.atanh(torch.clamp((v - mid) / half, -1.0 + 1e-12,
                                       1.0 - 1e-12))
    return to_box, from_box


def descend(f, u0: torch.Tensor, iters: int = 300, gtol: float = 1e-9):
    """Minimize each row's own problem f(u) (B, k) -> (B,) from u0, in
    float64, by BFGS with a backtracking (Armijo) line search, all rows at
    once. A row whose value is not finite at its start stays there.
    Returns (u, f(u))."""
    def value_grad(u):
        u = u.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(u)
            g, = torch.autograd.grad(torch.where(torch.isfinite(v), v,
                                                 torch.zeros_like(v)).sum(),
                                     u)
        return v.detach(), g

    b, k = u0.shape
    eye = torch.eye(k, dtype=u0.dtype, device=u0.device)
    u = u0.detach().clone()
    fu, g = value_grad(u)
    h = eye.expand(b, k, k).clone()
    live = torch.isfinite(fu)
    for _ in range(iters):
        live = live & (g.abs().amax(-1) > gtol)
        if not bool(live.any()):
            break
        p = -(h @ g[..., None])[..., 0]
        slope = (g * p).sum(-1)
        uphill = slope >= 0
        h[uphill] = eye
        p = torch.where(uphill[:, None], -g, p)
        slope = (g * p).sum(-1)
        t = torch.ones(b, dtype=u.dtype, device=u.device)
        found = ~live
        u_new, f_new, g_new = u.clone(), fu.clone(), g.clone()
        for _ in range(50):
            ut = u + t[:, None] * p
            ft, gt = value_grad(ut)
            ok = ~found & torch.isfinite(ft) & (ft <= fu + 1e-4 * t * slope)
            u_new[ok], f_new[ok], g_new[ok] = ut[ok], ft[ok], gt[ok]
            found = found | ok
            if bool(found.all()):
                break
            t = torch.where(found, t, 0.5 * t)
        moved = found & live
        live = moved & (f_new < fu)
        s = u_new - u
        yv = g_new - g
        sy = (s * yv).sum(-1)
        upd = moved & (sy > 1e-12)
        rho = torch.where(upd, 1.0 / torch.where(upd, sy, 1.0), 0.0)
        w = eye - rho[:, None, None] * (s[:, :, None] * yv[:, None, :])
        h_new = (w @ h @ w.transpose(-1, -2)
                 + rho[:, None, None] * s[:, :, None] * s[:, None, :])
        h = torch.where(upd[:, None, None], h_new, h)
        u = torch.where(moved[:, None], u_new, u)
        fu = torch.where(moved, f_new, fu)
        g = torch.where(moved[:, None], g_new, g)
    return u, fu


# -- mlegp's ARD GP ----------------------------------------------------------

def ard_nll(x, y, log_rates, prec: Precision = F64):
    """nll at each row of log_rates (B, d) -> (B,)."""
    x, y = x.to(prec.dtype), y.to(prec.dtype)
    n = x.shape[0]
    r = corr(x, x, torch.exp(_like(log_rates, x)))
    eye = torch.eye(n, dtype=prec.dtype, device=x.device)
    off = torch.amax(r * (1.0 - eye), dim=(-2, -1))
    _, _, a, logdet = _gls(_cholesky(r, 0.0), y)
    val = logdet + n * torch.log((a * a).sum(-1) / n)
    ok = (off < RIDGE) & torch.isfinite(val)
    return torch.where(ok, val, torch.full_like(val, math.inf))


def ard_predict(x, y, log_rates, x_new, alpha: float,
                prec: Precision = F64) -> dict:
    """mlegp's mean and t interval at x_new (t, d); beta and sigma^2 as
    `reference.combined_gp.plugin` makes them (its `_gls`)."""
    x, y, x_new = (v.to(prec.dtype) for v in (x, y, x_new))
    rates = torch.exp(_like(log_rates, x))
    chol = _cholesky(corr(x, x, rates), 0.0)
    beta, _, a, _ = _gls(chol, y)
    sigma2 = (a * a).sum() / y.shape[-1]
    v = _solve(chol, corr(x, x_new, rates))                  # (n, t)
    mean = beta + a @ v
    se = torch.sqrt(torch.clamp_min(sigma2 * (1.0 - (v * v).sum(0)), 0.0))
    half = t_quantile(1.0 - alpha / 2.0, y.shape[-1] - 1) * se
    return {"mean": mean, "lower": mean - half, "upper": mean + half}


def ard_starts(x, y, key, n_random: int, box, jitter: float = 0.0):
    """The specified search's starts (B, d): the isotropic optimum by the
    grid of 32 and the zoom of 17 over log-rates [-5, 6], on every axis;
    then per axis the kicks +2, -2, +4, -4 of its log rate; then n_random
    Gaussian starts around the first, scaled 0.5, 1, 2 in turn, from the
    threefry normals of key; all clipped to the box."""
    x, y = x.double(), y.double()
    d = x.shape[-1]
    base = grid_search(x, y, jitter, (-5.0, 6.0), 32, 17).expand(d)
    starts = [base]
    for j in range(d):
        for kick in (2.0, -2.0, 4.0, -4.0):
            s = base.clone()
            s[j] += kick
            starts.append(s)
    if n_random:
        noise = threefry.normal(key.to(x.device), (n_random, d),
                                torch.float64)
        scales = torch.tensor([(0.5, 1.0, 2.0)[i % 3]
                               for i in range(n_random)],
                              dtype=torch.float64, device=x.device)
        starts.extend(base + scales[:, None] * noise)
    return torch.clamp(torch.stack(starts), float(box[0]), float(box[1]))


def ard_descend(x, y, starts, box, iters: int = 300):
    """The least nll the descent reaches from each start (B, d) inside
    the log-rate box, float64: (log_rates (B, d), nll (B,))."""
    x, y = x.double(), y.double()
    d = x.shape[-1]
    lo = torch.full((d,), float(box[0]), dtype=torch.float64,
                    device=x.device)
    hi = torch.full((d,), float(box[1]), dtype=torch.float64,
                    device=x.device)
    to_box, from_box = tanh_map(lo, hi)
    u, f = descend(lambda u: ard_nll(x, y, to_box(u)),
                   from_box(torch.as_tensor(starts).double().to(x.device)),
                   iters)
    return to_box(u), f


# -- the composite GP --------------------------------------------------------

def cgp_scale(x):
    """(design scaled to [0, 1] per axis, the axes' ranges)."""
    lo = x.amin(0)
    scale = x.amax(0) - lo
    return (x - lo) / scale, scale


def cgp_box(x_std) -> tuple:
    """(lower, upper) of w on the scaled design."""
    n, p = x_std.shape
    i, j = torch.triu_indices(n, n, 1, device=x_std.device)
    diff = x_std[i] - x_std[j]
    m = (1.0 / (diff * diff).sum(-1)).mean()
    a, k = math.log(1e2) * m, math.log(1e6) * m
    one = torch.ones((), dtype=x_std.dtype, device=x_std.device)
    lower = torch.cat([1e-3 * one[None], torch.full((p,), 1e-4,
                                                    dtype=x_std.dtype,
                                                    device=x_std.device),
                       a[None], 0.0 * one[None]])
    upper = torch.cat([one[None], a.expand(p), k[None], one[None]])
    return lower, upper


def _local_variances(x, y, theta, alpha, lam, bw, prec: Precision):
    """The fixed-point loop at rates theta, alpha (..., p), lambda and bw
    (...): (s normalized, sf, e, chol of Q, Q's `_gls`: beta, L^-1 1,
    L^-1 (y - beta), log det Q)."""
    g = corr(x, x, theta)
    l_ = corr(x, x, alpha)
    b = corr(x, x, bw[..., None] * theta)
    ones = torch.ones(g.shape[:-1], dtype=prec.dtype, device=x.device)
    s = ones
    lam2 = lam[..., None, None]
    for _ in range(4):
        rs = torch.sqrt(s)
        chol = _cholesky(g + lam2 * rs[..., :, None] * l_
                         * rs[..., None, :], 0.0)
        beta, _, a, _ = _gls(chol, y)
        e = y - beta[..., None] - (g @ back_solve(chol, a)[..., None])[
            ..., 0]
        s_new = (b @ (e * e)[..., None])[..., 0] / (b @ ones[..., None])[
            ..., 0]
        sf = s_new.mean(-1)
        s = s_new / sf[..., None]
    rs = torch.sqrt(s)
    chol = _cholesky(g + lam2 * rs[..., :, None] * l_ * rs[..., None, :],
                     0.0)
    return s, sf, e, chol, _gls(chol, y)


def cgp_objective(x_std, y, w, prec: Precision = F64):
    """var.MLE.DK at each row of w (B, p + 3) -> (B,)."""
    x_std, y = x_std.to(prec.dtype), y.to(prec.dtype)
    w = _like(w, x_std)
    p = x_std.shape[-1]
    lam, theta, kappa, bw = w[:, 0], w[:, 1:p + 1], w[:, p + 1], w[:, p + 2]
    _, _, _, _, (_, _, a, logdet) = _local_variances(
        x_std, y, theta, kappa[:, None] + theta, lam, bw, prec)
    n = y.shape[-1]
    val = logdet + n * torch.log((a * a).sum(-1) / n)
    return torch.where(torch.isfinite(val), val, torch.full_like(val, 1e6))


def cgp_w(x, theta, alpha, lam, bw) -> torch.Tensor:
    """w (p + 3,) on the scaled design from the original-scale rates."""
    scale2 = cgp_scale(x.double())[1] ** 2
    theta, alpha = theta.double(), alpha.double()
    return torch.cat([lam.double().reshape(1), theta * scale2,
                      ((alpha - theta) * scale2).mean().reshape(1),
                      bw.double().reshape(1)])


def cgp_descend(x, y, w0, iters: int = 300):
    """The least objective the descent reaches from each w0 (B, p + 3)
    inside the box, float64: (w, objective)."""
    x_std, _ = cgp_scale(x.double())
    lo, hi = cgp_box(x_std)
    to_box, from_box = tanh_map(lo, hi)
    u, f = descend(lambda u: cgp_objective(x_std, y.double(), to_box(u)),
                   from_box(torch.as_tensor(w0).double().to(x.device)),
                   iters)
    return to_box(u), f


def cgp_state(x, y, theta, alpha, lam, bw, prec: Precision = F64) -> dict:
    """The fit at the original-scale rates: s, sf, e^2, Q's factor, beta,
    L^-1 1, Q^-1 (y - beta) and tau2."""
    x, y = x.to(prec.dtype), y.to(prec.dtype)
    theta, alpha, lam, bw = (_like(v, x) for v in (theta, alpha, lam, bw))
    s, sf, e, chol, (beta, u, a, _) = _local_variances(
        x, y, theta, alpha, lam, bw, prec)
    return {"s": s, "sf": sf, "res2": e * e, "chol": chol, "beta": beta,
            "u": u, "temp": back_solve(chol, a),
            "tau2": (a * a).sum() / y.shape[-1],
            "theta": theta, "alpha": alpha, "lam": lam, "bw": bw}


def cgp_jackknife(x, y, theta, alpha, lam, bw, prec: Precision = F64):
    """The jackknife RMSCV at the fit's rates."""
    x, y = x.to(prec.dtype), y.to(prec.dtype)
    theta, alpha, lam, bw = (_like(v, x) for v in (theta, alpha, lam, bw))
    n = x.shape[0]
    errs = []
    for j in range(n):
        keep = torch.cat([torch.arange(j), torch.arange(j + 1, n)]).to(
            x.device)
        xs, ys = x[keep], y[keep]
        st = cgp_state(xs, ys, theta, alpha, lam, bw, prec)
        pred = _cgp_at(xs, st, x[j:j + 1])
        errs.append(y[j] - pred["mean"][0])
    e = torch.stack(errs)
    return torch.sqrt((e * e).mean())


def _cgp_at(x, st, x_new) -> dict:
    g = corr(x_new, x, st["theta"])                  # (t, n)
    l_ = corr(x_new, x, st["alpha"])
    b = corr(x_new, x, st["bw"] * st["theta"])
    v = (b @ st["res2"]) / b.sum(-1) / st["sf"]
    q = g + st["lam"] * torch.sqrt(v)[:, None] * l_ * torch.sqrt(st["s"])
    mean = st["beta"] + q @ st["temp"]
    return {"mean": mean, "q": q, "v": v}


def cgp_predict(x, y, theta, alpha, lam, bw, x_new,
                prec: Precision = F64) -> dict:
    """predict.CGP's mean and interval at x_new (t, p), and the fit's
    local variances."""
    st = cgp_state(x, y, theta, alpha, lam, bw, prec)
    x, x_new = x.to(prec.dtype), x_new.to(prec.dtype)
    at = _cgp_at(x, st, x_new)
    w = _solve(st["chol"], at["q"].T)                        # (n, t)
    u = st["u"]
    var = st["tau2"] * (1.0 + st["lam"] * at["v"] - (w * w).sum(0)
                        + (1.0 - u @ w) ** 2 / (u * u).sum())
    half = 1.96 * torch.sqrt(torch.clamp_min(var, 0.0))
    mean = at["mean"]
    return {"mean": mean, "lower": mean - half, "upper": mean + half,
            "s": st["s"], "tau2": st["tau2"]}


# -- the table ---------------------------------------------------------------

def summary(y_true, predictions: dict) -> dict:
    """{"rmspe": {model: ...}, "coverage": {model: ...}, "quantile": the
    combined model's mean calibration quantile or None}, over the test
    points where the model's mean and y are finite. predictions: model ->
    dict of "mean", optional "lower" / "upper" / "quant"."""
    y_true = torch.as_tensor(y_true, dtype=torch.float64)
    out = {"rmspe": {}, "coverage": {}, "quantile": None}
    for name, p in predictions.items():
        mean = torch.as_tensor(p["mean"], dtype=torch.float64)
        keep = torch.isfinite(mean) & torch.isfinite(y_true)
        e = (y_true - mean)[keep]
        out["rmspe"][name] = float(torch.sqrt((e * e).mean()))
        if p.get("lower") is not None and p.get("upper") is not None:
            lo = torch.as_tensor(p["lower"], dtype=torch.float64)[keep]
            hi = torch.as_tensor(p["upper"], dtype=torch.float64)[keep]
            yt = y_true[keep]
            out["coverage"][name] = float(((yt >= lo) & (yt <= hi)).double()
                                          .mean())
        if p.get("quant") is not None:
            out["quantile"] = float(torch.as_tensor(
                p["quant"], dtype=torch.float64)[keep].mean())
    return out
