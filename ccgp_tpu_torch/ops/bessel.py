"""Modified Bessel function of the second kind K_v for real order (port of
`ccgp_tpu/ops/bessel.py`).

The classical two-regime algorithm: Temme's series for x <= 2, Steed's
continued fraction for x > 2 (Numerical Recipes' `bessik`), as
fixed-trip-count elementwise code. Both regimes are evaluated on clamped
inputs (x_lo = min(x, 2), x_hi = max(x, 2)) and `torch.where` picks one,
as in JAX; the order v is a Python float, so the recurrence that raises
the order from mu = v - round(v) to v unrolls.

`bessel_kve` and `bessel_kv` carry JAX's derivative rules
(dK_v/dx = (v/x) K_v - K_{v+1}) as `torch.autograd.Function`s that work
under `torch.func` (the Laplace step takes a forward-over-reverse Hessian
through them): the rule's K_v and K_{v+1} come from the plain pair code,
which a second derivative differentiates directly, as JAX differentiates
its rule.
"""
from __future__ import annotations

import math

import torch

# Taylor coefficients of 1/Gamma(1+z) = sum_k d_k z^k (A&S 6.1.34 shifted).
_D = (
    1.0,
    0.5772156649015329,
    -0.6558780715202538,
    -0.0420026350340952,
    0.1665386113822915,
    -0.0421977345555443,
    -0.0096219715278770,
    0.0072189432466630,
    -0.0011651675918591,
    -0.0002152416741149,
    0.0001280502823882,
    -0.0000201348547807,
    -0.0000012504934821,
    0.0000011330272320,
    -0.0000002056338417,
    0.0000000061160950,
    0.0000000050020075,
    -0.0000000011812746,
    0.0000000001043427,
    0.0000000000077823,
    -0.0000000000036968,
    0.0000000000005100,
)

_TEMME_ITERS = 24
_CF2_ITERS = 64


def _gamma_pair(mu: float):
    """Temme's Gamma1, Gamma2 and 1/Gamma(1 +- mu) for |mu| <= 1/2."""
    mu2 = mu * mu
    odd = _D[1::2]
    even = _D[0::2]
    gam1 = odd[-1]
    for coef in reversed(odd[:-1]):
        gam1 = coef + mu2 * gam1
    gam1 = -gam1
    gam2 = even[-1]
    for coef in reversed(even[:-1]):
        gam2 = coef + mu2 * gam2
    gampl = gam2 - mu * gam1  # 1/Gamma(1+mu)
    gammi = gam2 + mu * gam1  # 1/Gamma(1-mu)
    return gam1, gam2, gampl, gammi


def _temme_pair(mu: float, x: torch.Tensor):
    """(K_mu, K_{mu+1}) by Temme's series; accurate for 0 < x <= 2."""
    gam1, gam2, gampl, gammi = _gamma_pair(mu)
    x2 = 0.5 * x
    d = -torch.log(x2)
    e = mu * d
    # mu pi / sin(mu pi) == 1 / sinc(mu)
    fact = (1.0 / math.sin(math.pi * mu) * (math.pi * mu)
            if mu != 0.0 else 1.0)
    small = torch.abs(e) < 1e-12
    e_safe = torch.where(small, torch.ones_like(e), e)
    fact2 = torch.where(small, 1.0 + e * e / 6.0, torch.sinh(e_safe) / e_safe)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    summ = ff
    ee = torch.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = torch.ones_like(x)
    d2 = x2 * x2
    sum1 = p
    for i in range(1, _TEMME_ITERS + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu * mu)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        summ = summ + c * ff
        sum1 = sum1 + c * (p - fi * ff)
    return summ, sum1 * (2.0 / x)


def _cf2_pair(mu: float, x: torch.Tensor):
    """(e^x K_mu, e^x K_{mu+1}) by Steed's continued fraction; accurate for
    x >= 2. Every carried quantity freezes once its element has converged
    (running on overflows `c` in float32)."""
    eps = 1e-16 if x.dtype == torch.float64 else 1e-8
    a1 = 0.25 - mu * mu
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    q = torch.full_like(x, a1)
    c = torch.full_like(x, a1)
    a = torch.full_like(x, -a1)
    s = 1.0 + q * delh
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _CF2_ITERS + 2):
        fi = float(i)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        done_n = done | (torch.abs(dels) < torch.abs(s_n) * eps)
        # one select over the stacked carry (the same values as ten)
        old = torch.stack([b, d, h, delh, q1, q2, q, c, a, s])
        new = torch.stack([b_n, d_n, h_n, delh_n, q2, qnew, q_n, c_n, a_n,
                           s_n])
        b, d, h, delh, q1, q2, q, c, a, s = torch.where(done, old, new)
        done = done_n
    h = a1 * h
    k_mu = torch.sqrt(math.pi / (2.0 * x)) / s
    return k_mu, k_mu * (mu + x + 0.5 - h) / x


def _kv_pair_scaled(v: float, x: torch.Tensor):
    """(e^x K_v(x), e^x K_{v+1}(x)) for a real order v >= 0, elementwise
    in x > 0."""
    v = float(v)
    if v < 0:
        raise ValueError("bessel_kv: order must be >= 0 (K_{-v} = K_v)")
    nl = int(v + 0.5)
    mu = v - nl  # |mu| <= 1/2
    # minimum / maximum (not clamp): at x = 2 the derivative is split
    # between the two regimes, as JAX splits it
    two = torch.full_like(x, 2.0)
    x_lo = torch.minimum(x, two)
    x_hi = torch.maximum(x, two)
    kt, kt1 = _temme_pair(mu, x_lo)
    scale_lo = torch.exp(x_lo)
    kc, kc1 = _cf2_pair(mu, x_hi)
    use_temme = x <= 2.0
    k = torch.where(use_temme, kt * scale_lo, kc)
    k1 = torch.where(use_temme, kt1 * scale_lo, kc1)
    for j in range(nl):
        k, k1 = k1, 2.0 * (mu + j + 1.0) / x * k1 + k
    return k, k1


def bessel_kve_pair(v: float, x: torch.Tensor):
    """Exponentially scaled pair (e^x K_v, e^x K_{v+1})."""
    return _kv_pair_scaled(v, x)


class _Kve(torch.autograd.Function):
    """e^x K_v(x) with the derivative e^x K_v (1 + v/x) - e^x K_{v+1}."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, v):
        return _kv_pair_scaled(v, x)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, v = inputs
        ctx.v = v
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def _slope(v, x):
        k, k1 = _kv_pair_scaled(v, x)
        return k + (v / x) * k - k1

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _Kve._slope(ctx.v, x), None

    @staticmethod
    def jvp(ctx, x_t, _v_t):
        (x,) = ctx.saved_tensors
        return _Kve._slope(ctx.v, x) * x_t


class _Kv(torch.autograd.Function):
    """K_v(x) with the derivative (v/x) K_v - K_{v+1}."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, v):
        return _kv_pair_scaled(v, x)[0] * torch.exp(-x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, v = inputs
        ctx.v = v
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def _slope(v, x):
        ks, k1s = _kv_pair_scaled(v, x)
        e = torch.exp(-x)
        return (v / x) * (ks * e) - k1s * e

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _Kv._slope(ctx.v, x), None

    @staticmethod
    def jvp(ctx, x_t, _v_t):
        (x,) = ctx.saved_tensors
        return _Kv._slope(ctx.v, x) * x_t


def bessel_kve(v: float, x: torch.Tensor) -> torch.Tensor:
    """Exponentially scaled e^x K_v(x) for a real order v >= 0."""
    return _Kve.apply(x, float(v))


def bessel_kv(v: float, x: torch.Tensor) -> torch.Tensor:
    """K_v(x) for a real order v >= 0, elementwise in x > 0."""
    return _Kv.apply(x, float(v))


def log_bessel_kv(v: float, x: torch.Tensor) -> torch.Tensor:
    """log K_v(x), stable for large x (no underflow)."""
    return torch.log(bessel_kve(v, x)) - x
