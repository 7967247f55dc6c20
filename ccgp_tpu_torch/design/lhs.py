"""Latin hypercube designs (port of `ccgp_tpu/design/lhs.py`): the
reference's `lhs::randomLHS`, a best-of-k maximin stand-in and
`optimum_lhs`, the columnwise-pairwise swap search that takes the place of
`lhs::optimumLHS` for the design searches' starts. All follow the JAX
package's key order, so a key gives the same design bit for bit:
split(key) -> (kp, ku), uniform(ku, (n, d)), split(kp, d), one
`rng.permutation` per column; every entry is (perm + u) / n and a swap
search only moves entries within a column.
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


def _s_criterion(x: torch.Tensor) -> torch.Tensor:
    """The S-criterion of each design (..., n, d): the sum of inverse
    squared pairwise distances over the ordered pairs (minimize)."""
    n = x.shape[-2]
    d2 = torch.sum((x[..., :, None, :] - x[..., None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.eye(n, dtype=x.dtype, device=x.device)  # diagonal: n
    return torch.sum(1.0 / d2, dim=(-2, -1)) - n


def optimum_lhs(key: torch.Tensor, n: int, d: int, max_sweeps: int = 2,
                dtype=torch.float64) -> torch.Tensor:
    """Columnwise-pairwise swap-optimized LHS: from `random_lhs`, column by
    column, apply the best S-criterion-improving swap of two entries until
    the column improves no more or n swaps were made; `max_sweeps` passes
    over the columns. Every swap of a column (the n (n - 1) / 2 pairs in
    `triu_indices` order) is scored as one batch and the first best
    taken, a steepest-descent form of R's serial first-improvement walk."""
    x = random_lhs(key, n, d, dtype)
    ii, jj = torch.triu_indices(n, n, offset=1, device=x.device)
    pairs = torch.arange(ii.shape[0], device=x.device)
    # row p of `swapped` reorders a column by swapping entries ii[p], jj[p]
    swapped = torch.arange(n, device=x.device).repeat(ii.shape[0], 1)
    swapped[pairs, ii] = jj
    swapped[pairs, jj] = ii
    for _ in range(max_sweeps):
        for c in range(d):
            for _ in range(n):
                cands = x.repeat(ii.shape[0], 1, 1)
                cands[:, :, c] = x[:, c][swapped]
                scores = _s_criterion(cands)
                b = int(torch.argmin(scores))
                if not bool(scores[b] < _s_criterion(x)):
                    break
                x = cands[b]
    return x
