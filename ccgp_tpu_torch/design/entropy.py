"""Maximum-entropy design criteria for the combined GP (port of
`ccgp_tpu/design/entropy.py`; reference `Batch Sequential ME Designs/Batch
Sequential ME Design.R:853-878`).

* first batch: maximize det R_mix(D), scored as -log det (or -det with
  criterion="det", the reference's own objective);
* second batch given D_old: maximize the log det of the Schur complement
  R_new - R_cross R_old^-1 R_cross', the conditional entropy of the new
  batch, with R_old factored once per search.

A singular or NaN Gram scores +inf (the worst), never NaN. Both criteria
are differentiable through `torch.autograd`; the Cholesky is
`linalg.jitter_cholesky` (`torch.linalg.cholesky_ex`), as JAX computes it
outside any kernel.
"""
from __future__ import annotations

import math

import torch

from ccgp_tpu_torch.models.combination import (
    MixParams, MixtureSpec, mixed_cross, mixed_gram)
from ccgp_tpu_torch.ops import linalg


def _score(r: torch.Tensor, criterion: str, jitter) -> torch.Tensor:
    """-det r or -log det r, +inf where it is not finite."""
    inf = torch.full((), math.inf, dtype=r.dtype, device=r.device)
    if criterion == "det":
        det = -torch.linalg.det(r)
        return torch.where(torch.isfinite(det), det, inf)
    ld = linalg.logdet_psd(r, jitter)
    return -torch.where(torch.isfinite(ld), ld, -inf)


def me_criterion(spec: MixtureSpec, d: torch.Tensor, params: MixParams,
                 criterion: str = "logdet", jitter=0.0) -> torch.Tensor:
    """Score to minimize for a first-batch ME design d (n, dim)."""
    return _score(mixed_gram(spec, d, params), criterion, jitter)


def augmented_me_criterion(spec: MixtureSpec, d_old: torch.Tensor,
                           chol_old: torch.Tensor, d_new: torch.Tensor,
                           params: MixParams, criterion: str = "logdet",
                           jitter=0.0) -> torch.Tensor:
    """Score to minimize for a second batch d_new given d_old, whose
    R_mix has the lower Cholesky factor chol_old."""
    r_new = mixed_gram(spec, d_new, params)
    r_cross = mixed_cross(spec, d_old, d_new, params,
                          predict=False).transpose(-1, -2)   # (m, n_old)
    return _score(linalg.schur_complement(r_new, r_cross, chol_old),
                  criterion, jitter)
