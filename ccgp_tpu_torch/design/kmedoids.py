"""k-medoids clustering, the alternating (Voronoi-iteration) variant of
PAM (port of `ccgp_tpu/design/kmedoids.py`): assign every point to its
nearest medoid, then re-pick each cluster's medoid as the member with the
least summed in-cluster distance. The reference ships the output of such
a clustering (`Batch Sequential ME Designs/k-medoids ME Design.txt`) but
not its code.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ccgp_tpu_torch.ops import rng


class KMedoidsResult(NamedTuple):
    medoids: torch.Tensor      # (k, d) medoid coordinates
    medoid_idx: torch.Tensor   # (k,) indices into the input points
    labels: torch.Tensor       # (n,) cluster assignment
    cost: torch.Tensor         # total distance to the assigned medoids


def kmedoids(x: torch.Tensor, k: int, key: torch.Tensor, n_iters: int = 50,
             n_restarts: int = 8, metric: str = "euclidean") -> KMedoidsResult:
    """Alternating k-medoids from `n_restarts` random starts, run as one
    batch; the lowest cost wins (the first on a tie). Restart r starts
    from the first k entries of `rng.permutation(split(key,
    n_restarts)[r], n)`, as `jax.random.choice(..., replace=False)` draws
    them."""
    n = x.shape[0]
    d2 = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(d2) if metric == "euclidean" else d2
    idx = torch.stack([rng.permutation(kr, n)[:k]
                       for kr in rng.split(key, n_restarts)])     # (R, k)
    inf = torch.tensor(math.inf, dtype=dist.dtype, device=dist.device)
    for _ in range(n_iters):
        labels = torch.argmin(dist[:, idx], dim=-1).T             # (R, n)
        onehot = torch.nn.functional.one_hot(labels, k).to(dist.dtype)
        # cost[r, i, c]: the summed distance from point i to the members
        # of restart r's cluster c, every restart in one product
        cost = (dist @ onehot.permute(1, 0, 2).reshape(n, -1)).reshape(
            n, n_restarts, k).permute(1, 0, 2)
        member = onehot > 0
        new_idx = torch.argmin(torch.where(member, cost, inf), dim=1)
        idx = torch.where(member.any(dim=1), new_idx, idx)  # keep if empty
    dm = dist[:, idx].permute(1, 0, 2)                            # (R, n, k)
    labels = torch.argmin(dm, dim=-1)
    costs = torch.sum(torch.amin(dm, dim=-1), dim=-1)
    best = int(torch.argmin(costs))
    return KMedoidsResult(medoids=x[idx[best]], medoid_idx=idx[best],
                          labels=labels[best], cost=costs[best])
