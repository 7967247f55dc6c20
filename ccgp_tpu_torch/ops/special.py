"""Special functions (port of `ccgp_tpu/ops/special.py`): the inverse of
the regularized lower incomplete gamma function and the inverse-gamma
quantile, for the empirical-Bayes hyperprior nodes (the reference's
`pscl::qigamma`)."""
from __future__ import annotations

import torch


def gammaincinv(a, q: torch.Tensor, n_newton: int = 30) -> torch.Tensor:
    """x such that P(a, x) = q, elementwise in q; a is a float or a tensor
    broadcast against q.

    Wilson-Hilferty start, then a fixed number of guarded Newton steps on
    the log scale, with the JAX package's clips (~1e-12 relative in
    float64 for q in (1e-12, 1 - 1e-12))."""
    q = torch.as_tensor(q)
    dt, dev = q.dtype, q.device
    a = torch.as_tensor(a, dtype=dt, device=dev)
    tiny = 1e-300 if dt == torch.float64 else 1e-30

    # Wilson-Hilferty: x ~ a (1 - 1/(9a) + z sqrt(1/(9a)))^3
    z = torch.special.ndtri(torch.clamp(q, 1e-15, 1.0 - 1e-15))
    c = 1.0 / (9.0 * a)
    x0 = a * (1.0 - c + z * torch.sqrt(c)) ** 3
    # the small-x expansion P(a, x) ~ x^a / Gamma(a + 1) where the cube
    # goes nonpositive (q very small)
    log_small = (torch.log(torch.clamp_min(q, tiny))
                 + torch.special.gammaln(a + 1.0)) / a
    x0 = torch.where(x0 <= 0.0, torch.exp(log_small), x0)
    t = torch.log(torch.clamp_min(x0, tiny))
    lg = torch.special.gammaln(a)
    for _ in range(n_newton):
        x = torch.exp(t)
        f = torch.special.gammainc(a, x) - q
        # dP/dx = x^(a-1) e^-x / Gamma(a); d/dt with x = e^t adds a factor x
        deriv = torch.exp(a * t - x - lg)
        t = t - torch.clamp(f / torch.clamp_min(deriv, tiny), -4.0, 4.0)
    return torch.exp(t)


def invgamma_quantile(p: torch.Tensor, a, b) -> torch.Tensor:
    """Quantile of InverseGamma(a, b) (X = b / Gamma(a, 1)):
    P(X <= x) = 1 - P(a, b / x), so x = b / gammaincinv(a, 1 - p)."""
    p = torch.as_tensor(p)
    b = torch.as_tensor(b, dtype=p.dtype, device=p.device)
    return b / gammaincinv(a, 1.0 - p)
