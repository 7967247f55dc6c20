"""Posterior-predictive prediction with Monte Carlo intervals (port of
`ccgp_tpu/predict/posterior.py`).

Per draw (`1D Codes and Designs/1D Combined GP Public.R:794-812`):
    mean = beta + r' R^-1 (y - beta 1)
    var  = sigma2 (1 - r' R^-1 r + (1 - 1'R^-1 r)^2 / 1'R^-1 1)
then one normal draw per posterior sample, the mean of the per-draw means,
and type-7 quantiles of the draws; negative-variance draws are masked out.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ccgp_tpu_torch.models.combination import (
    MixtureSpec, mix_weights, mixed_cross)
from ccgp_tpu_torch.ops import linalg, rng
from ccgp_tpu_torch.predict.factors import FactorCache, build_factors
from ccgp_tpu_torch.utils import stats


class PosteriorPrediction(NamedTuple):
    mean: torch.Tensor        # (t,) point predictions (mean of draw means)
    lower: torch.Tensor       # (t,) lower PI bound
    upper: torch.Tensor       # (t,) upper PI bound
    quant: torch.Tensor       # (t,) calibration quantile statistic
    draw_mean: torch.Tensor   # (m, t) per-draw predictive means
    draw_var: torch.Tensor    # (m, t) per-draw predictive variances


def predictive_moments(spec: MixtureSpec, cache: FactorCache,
                       x: torch.Tensor, x_new: torch.Tensor, sigma2,
                       var_scale: str = "sigma2",
                       normalized_cross: bool = True,
                       solve_mode: Optional[str] = None):
    """Per-draw predictive means and variances at x_new: ((m, t), (m, t)).

    solve_mode picks how v = L^-1 r is formed per draw, as in JAX:
    "trsm" (the default, also for None) one batched triangular solve
    against the (n, t) cross block; "inv_matmul" a triangular solve
    against I_n, then one batched matmul L^-1 @ r. The product must run in
    full precision (PyTorch's default; TF32 breaks the cancellation
    1 - r'R^-1 r). Any other value raises ValueError, where JAX's branch
    takes it as trsm."""
    if solve_mode not in (None, "trsm", "inv_matmul"):
        raise ValueError(f"solve_mode must be 'trsm' or 'inv_matmul', got "
                         f"{solve_mode!r}")
    r = mixed_cross(spec, x, x_new, cache.params, predict=True,
                    normalized=normalized_cross)             # (m, n, t)
    if solve_mode == "inv_matmul":
        chol = cache.chol
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        linv = linalg.tri_solve(chol, eye.expand_as(chol))  # (m, n, n)
        v = torch.matmul(linv, r)                            # (m, n, t)
    else:
        v = linalg.tri_solve(cache.chol, r)                  # (m, n, t)
    mean = cache.beta[:, None] + torch.einsum("mn,mnt->mt", cache.a, v)
    rinv_quad = torch.einsum("mnt,mnt->mt", v, v)
    one_rinv_r = torch.einsum("mn,mnt->mt", cache.u, v)
    denom = torch.sum(cache.u * cache.u, dim=-1)[:, None]
    scale = sigma2
    if var_scale == "marginal":
        _, _, s = mix_weights(cache.params.p)
        scale = (s * sigma2)[:, None]
    var = scale * (1.0 - rinv_quad + (1.0 - one_rinv_r) ** 2 / denom)
    return mean, var


def predictive_moments_lazy(spec: MixtureSpec, x: torch.Tensor,
                            y: torch.Tensor, x_new: torch.Tensor,
                            zs: torch.Tensor, betas: torch.Tensor, sigma2,
                            jitter=0.0, draw_chunk: int = 64,
                            var_scale: str = "sigma2",
                            normalized_cross: bool = True):
    """Draw-chunked predictive moments: the factors of `draw_chunk` draws
    at a time (`build_factors`; 64 draws with n <= 128 is one launch of
    the lanes factor kernel), their (chunk, t) moments, then the next
    chunk. Peak factor memory is draw_chunk n^2 instead of m n^2. The
    ragged last chunk is padded with repeats of the last draw, as in JAX,
    so every chunk has the same shape; the padding rows are dropped."""
    m = zs.shape[0]
    t = x_new.shape[-2]
    if m == 0:
        empty = torch.zeros((0, t), dtype=x.dtype, device=x.device)
        return empty, empty
    c = min(int(draw_chunk), m)
    nc = -(-m // c)
    pad = nc * c - m
    if pad:
        zs = torch.cat([zs, zs[-1:].expand(pad, zs.shape[1])])
        betas = torch.cat([betas, betas[-1:].expand(pad)])
    means, variances = [], []
    for k in range(nc):
        cache = build_factors(spec, x, y, zs[k * c:(k + 1) * c],
                              betas[k * c:(k + 1) * c], jitter=jitter)
        dm, dv = predictive_moments(spec, cache, x, x_new, sigma2,
                                    var_scale=var_scale,
                                    normalized_cross=normalized_cross)
        means.append(dm)
        variances.append(dv)
    return torch.cat(means)[:m], torch.cat(variances)[:m]


def posterior_predict(key: torch.Tensor, draw_mean: torch.Tensor,
                      draw_var: torch.Tensor, alpha: float = 0.05,
                      quant_ref: Optional[torch.Tensor] = None,
                      drop_negative_var: bool = True) -> PosteriorPrediction:
    """Aggregate per-draw moments into predictions and MC intervals.
    quant_ref=None uses the predictive mean mu0 (the >=2-D reference)."""
    valid = (draw_var >= 0.0 if drop_negative_var
             else torch.ones_like(draw_var, dtype=torch.bool))
    sd = torch.sqrt(torch.clamp_min(draw_var, 0.0))
    eps = rng.normal(key.to(draw_mean.device), tuple(draw_mean.shape),
                     draw_mean.dtype)
    pp = draw_mean + sd * eps                                # (m, t)
    mu0 = stats.masked_mean(draw_mean.T, valid.T)            # (t,)
    ref = mu0 if quant_ref is None else quant_ref
    quant = stats.masked_mean((ref[None, :] <= pp).T.to(pp.dtype), valid.T)
    lower, upper = stats.masked_quantile_pair(pp.T, valid.T, alpha / 2,
                                              1 - alpha / 2)
    return PosteriorPrediction(mean=mu0, lower=lower, upper=upper,
                               quant=quant, draw_mean=draw_mean,
                               draw_var=draw_var)
