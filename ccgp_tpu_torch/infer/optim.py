"""BFGS with the semantics of `jax.scipy.optimize.minimize(method="BFGS")`
(port of `ccgp_tpu/infer/optim.py` and of jax 0.9's
`_src/scipy/optimize/bfgs.py` and `line_search.py`), and the multistart
search over it.

Wright & Nocedal, Algorithm 6.1 with the strong-Wolfe line search of
Algorithm 3.5 and the zoom of Algorithm 3.6 (cubic, quadratic or
bisection steps), with jax's constants: gtol 1e-5 on the inf-norm, 10
line-search iterations, zoom stopping after 30 steps or when the bracket
shrinks below 1e-10 (1e-5 below 64 bits). The `lax.while_loop`s become
Python loops; the boolean-arithmetic state updates become branches with
the same outcome.

The objective is guarded as `_guard` does in JAX: a non-finite value
becomes 1e10 with a zero gradient, and non-finite gradient entries are
zeroed, so a line search that wanders into singular-Gram territory does
not poison the BFGS state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ccgp_tpu_torch.utils import trace, transforms


def _value_and_grad(fn, x: torch.Tensor):
    """Guarded value and gradient of fn at x (both detached); counts
    `bfgs.evals`."""
    trace.count("bfgs.evals")
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = fn(x)
        if bool(trace.readback(torch.isfinite(v))):
            (g,) = torch.autograd.grad(v, x)
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            return v.detach(), g.detach()
    return (torch.full_like(v.detach(), 1e10),
            torch.zeros_like(x.detach()))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = fb - fa - C * db
    d2 = fc - fa - C * dc
    A = (dc ** 2 * d1 + (-db ** 2) * d2) / denom
    B = ((-dc ** 3) * d1 + db ** 3 * d2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


class _Zoom(NamedTuple):
    failed: bool
    a_star: torch.Tensor
    phi_star: torch.Tensor
    dphi_star: torch.Tensor
    g_star: torch.Tensor


def _zoom(restricted, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi,
          phi_hi, dphi_hi, g_0) -> _Zoom:
    done = failed = False
    j = 0
    a_rec = (a_lo + a_hi) / 2.0
    phi_rec = (phi_lo + phi_hi) / 2.0
    a_star = torch.ones_like(a_lo)
    phi_star, dphi_star, g_star = phi_lo, dphi_lo, g_0
    delta1, delta2 = 0.2, 0.1
    threshold = 1e-5 if torch.finfo(a_lo.dtype).bits < 64 else 1e-10
    while not done and not failed:
        dalpha = a_hi - a_lo
        a = torch.minimum(a_hi, a_lo)
        b = torch.maximum(a_hi, a_lo)
        cchk = delta1 * dalpha
        qchk = delta2 * dalpha
        failed = failed or bool(trace.readback(dalpha <= threshold))
        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                              phi_rec)
        use_cubic = (j > 0 and bool(trace.readback(a_j_cubic > a + cchk))
                     and bool(trace.readback(a_j_cubic < b - cchk)))
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = (not use_cubic
                    and bool(trace.readback(a_j_quad > a + qchk))
                    and bool(trace.readback(a_j_quad < b - qchk)))
        if use_cubic:
            a_j = a_j_cubic
        elif use_quad:
            a_j = a_j_quad
        else:
            a_j = (a_lo + a_hi) / 2.0
        phi_j, dphi_j, g_j = restricted(a_j)
        hi_to_j = (bool(trace.readback(wolfe_one(a_j, phi_j)))
                   or bool(trace.readback(phi_j >= phi_lo)))
        star_to_j = bool(trace.readback(wolfe_two(dphi_j))) and not hi_to_j
        hi_to_lo = (bool(trace.readback(dphi_j * (a_hi - a_lo) >= 0.0))
                    and not hi_to_j and not star_to_j)
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
        if star_to_j:
            done = True
            a_star, phi_star, dphi_star, g_star = a_j, phi_j, dphi_j, g_j
        if hi_to_lo:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
        if lo_to_j and not hi_to_lo:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return _Zoom(failed, a_star, phi_star, dphi_star, g_star)


class _LineSearch(NamedTuple):
    failed: bool
    a_k: torch.Tensor
    f_k: torch.Tensor
    g_k: torch.Tensor


def line_search(vg, xk, pk, old_fval, old_old_fval, gfk, c1=1e-4, c2=0.9,
                maxiter=20) -> _LineSearch:
    """Strong-Wolfe inexact line search (jax's `line_search`); vg(x) ->
    (value, gradient)."""

    def restricted(t):
        phi, g = vg(xk + t * pk)
        return phi, torch.dot(g, pk), g

    phi_0 = old_fval
    dphi_0 = torch.dot(gfk, pk)
    cand = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start_value = torch.where(cand > 1, torch.ones_like(cand), cand)

    def wolfe_one(a_i, phi_i):
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return torch.abs(dphi_i) <= -c2 * dphi_0

    done = failed = False
    i = 1
    a_i1 = torch.zeros_like(phi_0)
    phi_i1, dphi_i1 = phi_0, dphi_0
    a_star, phi_star, g_star = torch.zeros_like(phi_0), phi_0, gfk
    while not done and i <= maxiter and not failed:
        a_i = start_value if i == 1 else a_i1 * 2.0
        phi_i, dphi_i, g_i = restricted(a_i)
        to_zoom1 = (bool(trace.readback(wolfe_one(a_i, phi_i)))
                    or (bool(trace.readback(phi_i >= phi_i1)) and i > 1))
        to_i = bool(trace.readback(wolfe_two(dphi_i))) and not to_zoom1
        to_zoom2 = (bool(trace.readback(dphi_i >= 0.0)) and not to_zoom1
                    and not to_i)
        if to_zoom1:
            z = _zoom(restricted, wolfe_one, wolfe_two, a_i1, phi_i1,
                      dphi_i1, a_i, phi_i, dphi_i, gfk)
            done = True
            failed = failed or z.failed
            a_star, phi_star, g_star = z.a_star, z.phi_star, z.g_star
        if to_i:
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
        if to_zoom2:
            z = _zoom(restricted, wolfe_one, wolfe_two, a_i, phi_i, dphi_i,
                      a_i1, phi_i1, dphi_i1, gfk)
            done = True
            failed = failed or z.failed
            a_star, phi_star, g_star = z.a_star, z.phi_star, z.g_star
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    alpha_k = a_star
    if (torch.finfo(alpha_k.dtype).bits != 64
            and bool(trace.readback(torch.abs(alpha_k) < 1e-8))):
        alpha_k = torch.sign(alpha_k) * 1e-8
    return _LineSearch(failed or not done, alpha_k, phi_star, g_star)


@trace.span("bfgs")
def minimize_bfgs(fn, x0: torch.Tensor, maxiter: int = 100,
                  gtol: float = 1e-5, line_search_maxiter: int = 10):
    """Unconstrained BFGS on the guarded objective; returns (x, fun) as
    `jax.scipy.optimize.minimize(..., method="BFGS")` does (fun is the
    line search's value at x, which may be the guard's 1e10). Runs as the
    span `bfgs`, counting one of `bfgs.stop.converged`,
    `bfgs.stop.line_search` (its line search gave up) and
    `bfgs.stop.maxiter`."""
    x = x0.detach()
    d = x.shape[0]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def vg(z):
        return _value_and_grad(fn, z)

    f, g = vg(x)
    H = eye
    converged = bool(trace.readback(torch.max(torch.abs(g)) < gtol))
    failed = False
    k = 0
    old_old_fval = f + torch.linalg.vector_norm(g) / 2
    while not converged and not failed and k < maxiter:
        p = -(H @ g)
        ls = line_search(vg, x, p, old_fval=f, old_old_fval=old_old_fval,
                         gfk=g, maxiter=line_search_maxiter)
        failed = ls.failed
        s = ls.a_k * p
        x_new = x + s
        y = ls.g_k - g
        rho = 1.0 / torch.dot(y, s)
        w = eye - rho * (s[:, None] * y[None, :])
        H_new = w @ H @ w.T + rho * s[:, None] * s[None, :]
        H = torch.where(torch.isfinite(rho), H_new, H)
        converged = bool(trace.readback(torch.max(torch.abs(ls.g_k))
                                        < gtol))
        k += 1
        old_old_fval = f
        x, f, g = x_new, ls.f_k, ls.g_k
    trace.count("bfgs.stop." + ("converged" if converged else
                                "line_search" if failed else "maxiter"))
    return x, f


class MultistartResult(NamedTuple):
    x: torch.Tensor       # best point found (constrained space)
    fun: torch.Tensor     # objective value at x
    xs: torch.Tensor      # all restart solutions
    funs: torch.Tensor    # all restart objective values


def multistart_minimize(fn, starts: torch.Tensor,
                        lower: Optional[torch.Tensor] = None,
                        upper: Optional[torch.Tensor] = None,
                        maxiter: int = 100) -> MultistartResult:
    """Minimize fn from each of the starts (k, d), optionally in the box
    [lower, upper] through the tanh reparameterization (starts are then in
    the constrained space). JAX runs the restarts as one vmapped batch;
    here they run one after another, each the same BFGS. The best start is
    chosen by the objective re-evaluated at every solution (BFGS's reported
    value can belong to a point its line search left), non-finite values
    losing."""
    bounded = lower is not None
    if bounded:
        lower = torch.as_tensor(lower, dtype=starts.dtype,
                                device=starts.device)
        upper = torch.as_tensor(upper, dtype=starts.dtype,
                                device=starts.device)

        def obj(u):
            return fn(transforms.tanh_box(u, lower, upper))

        z0 = transforms.tanh_box_inverse(starts, lower, upper)
    else:
        obj = fn
        z0 = starts
    xs = torch.stack([minimize_bfgs(obj, z, maxiter)[0] for z in z0])
    with torch.no_grad():
        funs = torch.stack([obj(u) for u in xs])
    if bounded:
        xs = transforms.tanh_box(xs, lower, upper)
    funs = torch.where(torch.isfinite(funs), funs,
                       torch.full_like(funs, float("inf")))
    best = int(trace.readback(torch.argmin(funs)))
    return MultistartResult(x=xs[best], fun=funs[best], xs=xs, funs=funs)
