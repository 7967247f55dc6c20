"""Latin hypercube designs (port of `ccgp_tpu/design/lhs.py:11-39`): the
reference's `lhs::randomLHS` and a best-of-k maximin stand-in for
`lhs::optimumLHS`. Both follow the JAX package's key order, so a key gives
the same design bit for bit: split(key) -> (kp, ku), uniform(ku, (n, d)),
split(kp, d), one `rng.permutation` per column. `optimum_lhs` is not
ported yet (ROADMAP queue 1, with `batch_me_design`).
"""
from __future__ import annotations

import torch

from ccgp_tpu_torch.ops import rng


def random_lhs(key: torch.Tensor, n: int, d: int,
               dtype=torch.float64) -> torch.Tensor:
    """randomLHS: one uniform draw per stratum, the strata permuted per
    column. (n, d) on the key's device."""
    kp, ku = rng.split(key)
    u = rng.uniform(ku, (n, d), dtype)
    # a tensor divisor: PyTorch multiplies by the reciprocal of a scalar
    nt = torch.tensor(n, dtype=dtype, device=key.device)
    cols = [(rng.permutation(k, n).to(dtype) + u[:, j]) / nt
            for j, k in enumerate(rng.split(kp, d))]
    return torch.stack(cols, dim=1)


def _min_dist(x: torch.Tensor) -> torch.Tensor:
    """The smallest squared pairwise distance of each design (..., n, d)."""
    n = x.shape[-2]
    d2 = torch.sum((x[..., :, None, :] - x[..., None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.eye(n, dtype=x.dtype, device=x.device) * 1e9
    return torch.amin(d2, dim=(-2, -1))


def maximin_lhs(key: torch.Tensor, n: int, d: int, n_candidates: int = 32,
                dtype=torch.float64) -> torch.Tensor:
    """Best-of-k maximin LHS: `n_candidates` random LHDs, keeping the one
    with the largest minimum pairwise distance (the first on a tie)."""
    designs = torch.stack([random_lhs(k, n, d, dtype)
                           for k in rng.split(key, n_candidates)])
    return designs[torch.argmax(_min_dist(designs))]
