"""Plain reference of the Geweke diagnostic the sampler stops by (coda's
`geweke.diag` with `spectrum0.ar`, first 10% against last 50%): the
spectral density at frequency zero from the Yule-Walker AR fit of the
order that AIC picks, each order's equations solved directly (not by the
Levinson-Durbin recursion). Plain PyTorch only.
"""
from __future__ import annotations

import math

import torch


def spectrum0_ar(x: torch.Tensor) -> torch.Tensor:
    """Spectral density at 0 of each series x (..., n, m) along n."""
    n = x.shape[-2]
    km = min(n - 1, int(10.0 * math.log10(n)))
    xc = x - x.mean(-2, keepdim=True)
    c = torch.stack([(xc[..., :n - lag, :] * xc[..., lag:, :]).sum(-2) / n
                     for lag in range(km + 1)], -1)          # (..., m, km+1)
    v, sums = [c[..., 0]], [torch.zeros_like(c[..., 0])]
    for k in range(1, km + 1):
        idx = torch.abs(torch.arange(k)[:, None] - torch.arange(k)[None, :])
        toeplitz = c[..., idx.to(c.device)]                  # (..., m, k, k)
        phi = torch.linalg.solve(toeplitz, c[..., 1:k + 1])
        v.append(c[..., 0] - (phi * c[..., 1:k + 1]).sum(-1))
        sums.append(phi.sum(-1))
    v, sums = torch.stack(v, -1), torch.stack(sums, -1)      # (..., m, km+1)
    orders = torch.arange(km + 1, dtype=x.dtype, device=x.device)
    aic = n * torch.log(torch.clamp_min(v, 1e-300)) + 2.0 * orders
    best = torch.argmin(aic, dim=-1, keepdim=True)
    var = torch.gather(v * (n / (n - (orders + 1.0))), -1, best)[..., 0]
    return var / (1.0 - torch.gather(sums, -1, best)[..., 0]) ** 2


def pvalue(windows: torch.Tensor) -> torch.Tensor:
    """The least over parameters of the two-sided Geweke p-value of each
    window (..., n, dim); a non-finite one counts as 0."""
    n = windows.shape[-2]
    n1, n2 = int(0.1 * n), int(0.5 * n)
    a, b = windows[..., :n1, :], windows[..., n - n2:, :]
    z = ((a.mean(-2) - b.mean(-2))
         / torch.sqrt(spectrum0_ar(a) / n1 + spectrum0_ar(b) / n2))
    p = 2.0 * (1.0 - torch.special.ndtr(torch.abs(z)))
    return torch.where(torch.isfinite(p), p, torch.zeros_like(p)).amin(-1)
