"""Chain diagnostics (port of `ccgp_tpu/infer/diagnostics.py:39-59`).

`effective_sample_size` is the crude multi-chain ESS the experiments
report beside Geweke convergence (min over parameters,
`ccgp_tpu/experiments/common.py:128-131`): Geweke alone can hide a
random-walk chain that mixes badly.
"""
from __future__ import annotations

import torch


def effective_sample_size(chains: torch.Tensor,
                          max_lag: int = 100) -> torch.Tensor:
    """ESS per parameter by initial-positive-sequence truncation of the
    autocorrelations: chains (c, n, p) -> (p,)."""
    c, n, p = chains.shape
    xc = chains - torch.mean(chains, dim=1, keepdim=True)
    # the variance with ddof 1, as jnp.var computes it (centred squares)
    var = torch.mean(torch.sum(xc * xc, dim=1) / (n - 1), dim=0)   # (p,)
    lags = []
    for lag in range(1, min(max_lag, n - 1) + 1):
        acov = torch.mean(torch.sum(xc[:, :n - lag, :] * xc[:, lag:, :],
                                    dim=1) / (n - 1), dim=0)
        lags.append(acov / var)
    rho = torch.stack(lags)                                          # (L, p)
    # truncate at the first negative autocorrelation (per parameter)
    positive = torch.cumprod((rho > 0).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(rho * positive, dim=0)
    return c * n / tau
