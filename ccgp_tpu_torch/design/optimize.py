"""Multistart maximum-entropy design search (port of
`ccgp_tpu/design/optimize.py`; reference `Batch Sequential ME Designs/Batch
Sequential ME Design.R:883-949`): `n_starts` `optimum_lhs` starts scaled
to the box, each refined by box-constrained BFGS over the flattened
coordinates (`infer/optim.multistart_minimize`), the best kept. JAX runs
the restarts as one vmapped batch; here they run one after another. The
second batch's criterion reuses one factorization of R_old throughout.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ccgp_tpu_torch.design.entropy import augmented_me_criterion, me_criterion
from ccgp_tpu_torch.design.lhs import optimum_lhs
from ccgp_tpu_torch.infer.optim import MultistartResult, multistart_minimize
from ccgp_tpu_torch.models.combination import MixParams, MixtureSpec, mixed_gram
from ccgp_tpu_torch.ops import linalg, rng


class DesignResult(NamedTuple):
    design: torch.Tensor       # (n, d) best design found
    log_entropy: torch.Tensor  # log det criterion at the optimum
    score: torch.Tensor        # the minimized objective (criterion scale)


def _starts(key: torch.Tensor, n_pts: int, d: int, n_starts: int,
            box: Tuple[float, float], dtype: torch.dtype) -> torch.Tensor:
    """(n_starts, n_pts * d): an `optimum_lhs` per split(key, n_starts),
    scaled to the box and flattened."""
    lo, hi = box
    return torch.stack([lo + (hi - lo) * optimum_lhs(kk, n_pts, d,
                                                     dtype=dtype).reshape(-1)
                        for kk in rng.split(key, n_starts)])


def _search(objective, key: torch.Tensor, n_pts: int, d: int, n_starts: int,
            box: Tuple[float, float], maxiter: int,
            dtype: torch.dtype) -> MultistartResult:
    lo, hi = box
    k = n_pts * d
    return multistart_minimize(
        objective, _starts(key, n_pts, d, n_starts, box, dtype),
        lower=torch.full((k,), lo, dtype=dtype, device=key.device),
        upper=torch.full((k,), hi, dtype=dtype, device=key.device),
        maxiter=maxiter)


def me_design(spec: MixtureSpec, params: MixParams, n_pts: int, d: int,
              key: torch.Tensor, n_starts: int = 25,
              box: Tuple[float, float] = (-1.0, 1.0),
              criterion: str = "logdet", jitter=0.0,
              maxiter: int = 200) -> DesignResult:
    """First-batch ME design: maximize (log) det R_mix over the box. The
    design has params' dtype and lies on the key's device."""

    def obj(flat):
        return me_criterion(spec, flat.reshape(n_pts, d), params,
                            criterion=criterion, jitter=jitter)

    res = _search(obj, key, n_pts, d, n_starts, box, maxiter,
                  params.p.dtype)
    best = res.x.reshape(n_pts, d)
    with torch.no_grad():
        ld = linalg.logdet_psd(mixed_gram(spec, best, params), jitter)
    return DesignResult(design=best, log_entropy=ld, score=res.fun)


def batch_me_design(spec: MixtureSpec, params: MixParams,
                    d_old: torch.Tensor, n_new: int, key: torch.Tensor,
                    n_starts: int = 25,
                    box: Tuple[float, float] = (-1.0, 1.0),
                    criterion: str = "logdet", jitter=0.0,
                    maxiter: int = 200) -> DesignResult:
    """Second-batch augmented-entropy design of n_new points given the
    existing design d_old (n_old, d)."""
    d = d_old.shape[-1]
    chol_old = linalg.jitter_cholesky(mixed_gram(spec, d_old, params),
                                      jitter)

    def obj(flat):
        return augmented_me_criterion(spec, d_old, chol_old,
                                      flat.reshape(n_new, d), params,
                                      criterion=criterion, jitter=jitter)

    res = _search(obj, key, n_new, d, n_starts, box, maxiter, d_old.dtype)
    best = res.x.reshape(n_new, d)
    with torch.no_grad():
        ld = -augmented_me_criterion(spec, d_old, chol_old, best, params,
                                     criterion="logdet", jitter=jitter)
    return DesignResult(design=best, log_entropy=ld, score=res.fun)
