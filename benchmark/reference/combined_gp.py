"""Plain reference of the convex-combination GP (Harari & Steinberg 2014)
that the benchmark holds the measured program to. Plain PyTorch only: no
kernel, no cache, no import of the measured package or of JAX.

    R_mix   = (p^2 R1 + (1 - p)^2 R2) / (p^2 + (1 - p)^2),  R_k = exp(-D_k)
    D_k     = sum_a rate_ka (x_a - x'_a)^2
    beta    = 1'R^-1 y / 1'R^-1 1
    logpost = log N(y; beta 1, (p^2 + (1-p)^2) sigma2 R) + log|Jacobian|
              + log prior(theta1) + log prior(theta2)

The unconstrained draw z is (psi_1..psi_d, phi, zeta) for the anisotropic
model with a tied rough rate (theta1 = e^psi per axis, p = sigmoid(phi),
lambda = e^zeta, rough rate (1 + lambda) theta1), and (psi1, psi2, phi)
for the isotropic one with a free rough rate. The per-draw predictive
moments at new points t are

    mean = beta + r' R^-1 (y - beta 1)
    var  = sigma2 (1 - r' R^-1 r + (1 - 1'R^-1 r)^2 / 1'R^-1 1)

and the intervals are type-7 quantiles over the draws of mean + sd * eps,
eps the threefry normals of the query's key, draws of negative variance
left out.

The plug-in's objective is the ordinary-kriging profile criterion in the
isotropic log-rate, log det R + n log sigma2_hat, +inf where R's largest
off-diagonal entry reaches 1 - 1e-6 (the all-ones ridge). The Laplace
covariance is the inverse negative Hessian of the log-posterior at the
mode, symmetrized, its eigenvalues floored at 1e-4 of the largest; a
mode is a point from which an ascent gains nothing.

Every function takes a `Precision`: the reference runs in float64; the
control runs the same code in a lower precision. With `tf32` set, every
matrix product rounds its operands to TF32 (10 mantissa bits) first, as
the tensor cores do with TF32 enabled.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from reference import threefry

_LOG2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False


F64 = Precision()


@dataclass(frozen=True)
class Model:
    """The model of a configuration file's "model" section."""

    dim: int
    rough: str                  # "tied" | "free"
    anisotropic: bool
    theta1_prior: dict
    theta2_prior: dict

    @classmethod
    def from_config(cls, m: dict) -> "Model":
        if m["kernel"] != "sqexp":
            raise ValueError(f"the reference knows the sqexp kernel only, "
                             f"not {m['kernel']!r}")
        return cls(dim=int(m["dim"]), rough=m["rough"],
                   anisotropic=bool(m["anisotropic"]),
                   theta1_prior=m["theta1_prior"],
                   theta2_prior=m["theta2_prior"])


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest TF32 value (10 mantissa bits);
    the gradient passes through unchanged."""
    bits = a.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return a + (bits.view(torch.float32) - a).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.tf32:
        a, b = _round_tf32(a), _round_tf32(b)
    return torch.matmul(a, b)


def _log_kernel(prior: dict, x: torch.Tensor) -> torch.Tensor:
    if prior["kind"] == "inverse_gamma":
        return -(prior["a"] + 1.0) * torch.log(x) - prior["b"] / x
    if prior["kind"] == "lognormal":
        lx = torch.log(x)
        return -lx - 0.5 * ((lx - prior["mu"]) / prior["sigma"]) ** 2
    raise ValueError(f"unknown prior {prior['kind']!r}")


def unpack(model: Model, z: torch.Tensor):
    """z (B, k) -> (p (B,), rates1 (B, d), rates2 (B, d), log-Jacobian,
    log-prior)."""
    d = model.dim
    if model.anisotropic:
        psi, phi, zeta = z[:, :d], z[:, d], z[:, d + 1]
        th1 = torch.exp(psi)
        lam = torch.exp(zeta)
        log_jac = psi.sum(-1) + zeta
        prior = (_log_kernel(model.theta1_prior, th1).sum(-1)
                 + _log_kernel(model.theta2_prior, lam))
        second = lam
    else:
        psi1, psi2, phi = z[:, 0], z[:, 1], z[:, 2]
        th1 = torch.exp(psi1)[:, None].expand(-1, d)
        second = torch.exp(psi2)
        log_jac = psi1 + psi2
        prior = (_log_kernel(model.theta1_prior, th1[:, 0])
                 + _log_kernel(model.theta2_prior, second))
    if model.rough == "tied":
        th2 = (1.0 + second)[:, None] * th1
    elif model.rough == "free":
        th2 = second[:, None].expand(-1, d)
    else:
        raise ValueError(f"unknown rough mode {model.rough!r}")
    p = 1.0 / (1.0 + torch.exp(-phi))
    log_jac = log_jac + torch.log(p) + torch.log1p(-p)
    return p, th1, th2, log_jac, prior


def sqdist(a: torch.Tensor, b: torch.Tensor, rates: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """sum_k rate_k (a_ik - b_jk)^2 for a batch of rates (B, d): a (n, d),
    b (m, d) -> (B, n, m), through one matrix product per batch."""
    s = torch.sqrt(rates)[:, None, :]
    aw, bw = a[None] * s, b[None] * s
    inner = matmul(aw, bw.transpose(-1, -2), prec)
    d2 = ((aw * aw).sum(-1)[:, :, None] + (bw * bw).sum(-1)[:, None, :]
          - 2.0 * inner)
    return torch.clamp_min(d2, 0.0)


def mix_corr(model: Model, a, b, z, prec: Precision):
    p, th1, th2, _, _ = unpack(model, z)
    w1, w2 = p * p, (1.0 - p) * (1.0 - p)
    s = w1 + w2
    r = (w1[:, None, None] * torch.exp(-sqdist(a, b, th1, prec))
         + w2[:, None, None] * torch.exp(-sqdist(a, b, th2, prec)))
    return r / s[:, None, None]


def _cholesky(r: torch.Tensor, jitter: float) -> torch.Tensor:
    """Lower factor of r + jitter * mean(diag) I; NaN where it fails."""
    if jitter:
        scale = torch.diagonal(r, dim1=-2, dim2=-1).mean(-1)
        r = r + (jitter * scale)[..., None, None] * torch.eye(
            r.shape[-1], dtype=r.dtype, device=r.device)
    chol, info = torch.linalg.cholesky_ex(r)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, math.nan), chol)


def _solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(chol, b, upper=False)


def _gls(chol: torch.Tensor, y: torch.Tensor):
    """(beta, u = L^-1 1, a = L^-1 (y - beta 1), logdet) per factor."""
    n = y.shape[-1]
    rhs = torch.stack([y.expand(chol.shape[:-2] + (n,)),
                       torch.ones(chol.shape[:-2] + (n,), dtype=y.dtype,
                                  device=y.device)], -1)
    w = _solve(chol, rhs)
    wy, u = w[..., 0], w[..., 1]
    beta = (u * wy).sum(-1) / (u * u).sum(-1)
    a = _solve(chol, (y - beta[..., None])[..., None])[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return beta, u, a, logdet


def _center(x, *more):
    """Shift every point set by the training mean (distances unchanged)."""
    c = x.mean(0, keepdim=True)
    return (x - c,) + tuple(m - c for m in more)


def plugin(x, y, theta, jitter: float, prec: Precision = F64) -> dict:
    """The ordinary-kriging plug-in at the program's rate theta (scalar or
    per axis): beta and sigma2 = (y - beta 1)'R^-1 (y - beta 1) / n."""
    x, y = x.to(prec.dtype), y.to(prec.dtype)
    (x,) = _center(x)
    rates = torch.as_tensor(theta, dtype=prec.dtype, device=x.device)
    rates = rates.reshape(1, -1).expand(1, x.shape[-1])
    chol = _cholesky(torch.exp(-sqdist(x, x, rates, prec)), jitter)
    beta, _, a, _ = _gls(chol, y)
    return {"beta": beta[0], "sigma2": (a * a).sum(-1)[0] / y.shape[-1]}


def profile_objective(x, y, log_thetas, jitter: float,
                      prec: Precision = F64, block: int = 128):
    """The plug-in's objective at each isotropic log-rate of (B,)."""
    x, y = x.to(prec.dtype), y.to(prec.dtype)
    (x,) = _center(x)
    n, d = x.shape
    lts = torch.as_tensor(log_thetas, dtype=prec.dtype, device=x.device)
    eye = torch.eye(n, dtype=prec.dtype, device=x.device)
    out = []
    for i in range(0, lts.shape[0], block):
        rates = torch.exp(lts[i:i + block])[:, None].expand(-1, d)
        r = torch.exp(-sqdist(x, x, rates, prec))
        off = torch.amax(r * (1.0 - eye), dim=(-2, -1))
        _, _, a, logdet = _gls(_cholesky(r, jitter), y)
        obj = logdet + n * torch.log((a * a).sum(-1) / n)
        ok = (off < 1.0 - 1e-6) & torch.isfinite(obj)
        out.append(torch.where(ok, obj, torch.full_like(obj, math.inf)))
    return torch.cat(out)


def grid_search(x, y, jitter: float, box, n_grid: int, n_zoom: int,
                prec: Precision = F64) -> torch.Tensor:
    """The batched grid plug-in as specified: n_grid log-rates evenly over
    the box, the least one (kept off the ends), one parabolic step through
    its neighbours clamped to a spacing; then n_zoom log-rates over one
    spacing either side of that, the same step again. The log-rate."""
    dt, dev = prec.dtype, x.device

    def scan(center, half, m):
        step = 2.0 * half / (m - 1)
        mg = center + (-half + step * torch.arange(m, dtype=dt, device=dev))
        f = profile_objective(x, y, mg, jitter, prec)
        i = int(torch.clamp(torch.argmin(f), 1, m - 2))
        f0, f1, f2 = f[i - 1], f[i], f[i + 1]
        h = mg[1] - mg[0]
        denom = f0 - 2.0 * f1 + f2
        shift = torch.where(torch.abs(denom) > 1e-12,
                            0.5 * h * (f0 - f2) / denom,
                            torch.zeros_like(denom))
        return mg[i] + torch.clamp(shift, -h, h), h

    lo, hi = float(box[0]), float(box[1])
    lt, h = scan(torch.tensor(0.5 * (lo + hi), dtype=dt, device=dev),
                 0.5 * (hi - lo), n_grid)
    lt, _ = scan(lt, h, n_zoom)
    return lt


def scan_search(x, y, jitter: float, box, step: float = 0.02,
                zooms: int = 5, prec: Precision = F64) -> torch.Tensor:
    """The objective's least point over the box: a grid at `step`, then
    `zooms` grids of 33 over two spacings either side of the best node.
    The log-rate."""
    dt, dev = prec.dtype, x.device
    lo, hi = float(box[0]), float(box[1])
    m = int(round((hi - lo) / step)) + 1
    mg = torch.linspace(lo, hi, m, dtype=dt, device=dev)
    h = mg[1] - mg[0]
    best = mg[torch.argmin(profile_objective(x, y, mg, jitter, prec))]
    for _ in range(zooms):
        mg = torch.clamp(best + torch.linspace(-2.0, 2.0, 33, dtype=dt,
                                               device=dev) * h, lo, hi)
        best = mg[torch.argmin(profile_objective(x, y, mg, jitter, prec))]
        h = h / 8.0
    return best


def laplace_at(model: Model, x, y, sigma2, mode, jitter: float,
               prec: Precision = F64) -> torch.Tensor:
    """The Laplace covariance at `mode` (identity where the Hessian is not
    finite)."""
    def f(z):
        return logpost(model, x, y, sigma2, z[None], jitter, prec)["val"][0]

    hess = torch.autograd.functional.hessian(f, mode.detach().to(prec.dtype))
    p = -0.5 * (hess + hess.T)
    if not bool(torch.isfinite(p).all()):
        p = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
    w, q = torch.linalg.eigh(p)
    w = torch.maximum(w, torch.clamp_min(torch.abs(w).max() * 1e-4, 1e-12))
    return (q / w) @ q.T


def mode_gain(model: Model, x, y, sigma2, mode, jitter: float,
              iters: int = 100) -> float:
    """How far the log-posterior rises from `mode` under an L-BFGS ascent
    in float64 with a strong-Wolfe line search, nats: 0 at a mode."""
    z = mode.detach().double().clone().requires_grad_(True)

    def neg():
        return -logpost(model, x, y, sigma2, z[None], jitter)["val"][0]

    with torch.no_grad():
        start = float(neg())
    opt = torch.optim.LBFGS([z], lr=1.0, max_iter=iters, history_size=20,
                            tolerance_grad=1e-10, tolerance_change=1e-14,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        v = neg()
        v.backward()
        return v

    opt.step(closure)
    with torch.no_grad():
        end = float(neg())
    return max(0.0, start - end) if math.isfinite(end) else 0.0


def logpost(model: Model, x, y, sigma2, zs, jitter: float,
            prec: Precision = F64, block: int = 256) -> dict:
    """Log-posterior and GLS intercept at each draw of zs (B, k)."""
    x, y = x.to(prec.dtype), y.to(prec.dtype)
    (x,) = _center(x)
    s2 = torch.as_tensor(sigma2, dtype=prec.dtype, device=x.device)
    n = y.shape[-1]
    vals, betas = [], []
    for i in range(0, zs.shape[0], block):
        z = zs[i:i + block].to(prec.dtype)
        p, _, _, log_jac, prior = unpack(model, z)
        chol = _cholesky(mix_corr(model, x, x, z, prec), jitter)
        beta, _, a, logdet = _gls(chol, y)
        log_scale = torch.log((p * p + (1.0 - p) ** 2) * s2)
        like = -0.5 * (n * _LOG2PI + logdet + n * log_scale
                       + (a * a).sum(-1) * torch.exp(-log_scale))
        vals.append(like + log_jac + prior)
        betas.append(beta)
    return {"val": torch.cat(vals), "beta": torch.cat(betas)}


def moments(model: Model, x, y, x_new, sigma2, zs, jitter: float,
            prec: Precision = F64, block: int = 128) -> dict:
    """Per-draw predictive means and variances (B, t) at x_new."""
    x, y, x_new = (v.to(prec.dtype) for v in (x, y, x_new))
    x, x_new = _center(x, x_new)
    s2 = torch.as_tensor(sigma2, dtype=prec.dtype, device=x.device)
    means, variances = [], []
    for i in range(0, zs.shape[0], block):
        z = zs[i:i + block].to(prec.dtype)
        chol = _cholesky(mix_corr(model, x, x, z, prec), jitter)
        beta, u, a, _ = _gls(chol, y)
        v = _solve(chol, mix_corr(model, x, x_new, z, prec))   # (B, n, t)
        mean = beta[:, None] + matmul(a[:, None, :], v, prec)[:, 0]
        quad = (v * v).sum(1)
        one = matmul(u[:, None, :], v, prec)[:, 0]
        denom = (u * u).sum(-1)[:, None]
        means.append(mean)
        variances.append(s2 * (1.0 - quad + (1.0 - one) ** 2 / denom))
    return {"mean": torch.cat(means), "var": torch.cat(variances)}


def _type7(xs: torch.Tensor, m: torch.Tensor, q: float) -> torch.Tensor:
    """Type-7 quantile q of each sorted row over its first m entries."""
    h = (m.to(xs.dtype) - 1.0) * q
    lo = torch.clamp(torch.floor(h).long(), 0, xs.shape[-1] - 1)
    hi = torch.minimum(torch.clamp(lo + 1, max=xs.shape[-1] - 1),
                       torch.clamp_min(m - 1, 0))
    frac = h - lo.to(xs.dtype)
    xlo = xs.gather(-1, lo[..., None])[..., 0]
    xhi = xs.gather(-1, hi[..., None])[..., 0]
    return xlo + frac * (xhi - xlo)


def intervals(key: torch.Tensor, draw_mean, draw_var, alpha: float,
              draw_dtype: torch.dtype, prec: Precision = F64,
              block: int = 1024) -> dict:
    """Point predictions and (alpha/2, 1 - alpha/2) intervals from the
    per-draw moments (m, t). eps are the threefry normals of key in the
    configuration's dtype, the stream the program draws from."""
    m, t = draw_mean.shape
    eps = threefry.normal(key.to(draw_mean.device), (m, t),
                          draw_dtype).to(prec.dtype)
    dm, dv = draw_mean.to(prec.dtype), draw_var.to(prec.dtype)
    valid = dv >= 0.0
    w = valid.to(prec.dtype)
    mean = (dm * w).sum(0) / torch.clamp_min(w.sum(0), 1.0)
    pp = dm + torch.sqrt(torch.clamp_min(dv, 0.0)) * eps
    big = torch.finfo(prec.dtype).max
    lower, upper = [], []
    for j in range(0, t, block):
        cols = torch.where(valid[:, j:j + block], pp[:, j:j + block],
                           torch.full_like(pp[:, j:j + block], big)).T
        xs = torch.sort(cols, dim=-1).values
        cnt = valid[:, j:j + block].sum(0)
        lower.append(_type7(xs, cnt, alpha / 2))
        upper.append(_type7(xs, cnt, 1.0 - alpha / 2))
    return {"mean": mean, "lower": torch.cat(lower),
            "upper": torch.cat(upper)}

