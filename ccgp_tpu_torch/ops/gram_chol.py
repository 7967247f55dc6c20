"""The fused mixture-Gram -> Cholesky -> quadratics kernel (port of
`ccgp_tpu/ops/pallas_gram_chol.py`), exported as
`ccgp_tpu_torch.ops.fused_mix_quadratics` as JAX exports it.

For each lane b of a batch, with w1 = p_b^2 and w2 = (1 - p_b)^2,

    D1 = sum_k r1[b, k] (x_ik - x_jk)^2      D2 the same with r2[b]
    R  = (w1 e^{-D1} + w2 e^{-D2}) / (w1 + w2)
    C  = scale_b R + shift_b J + jitter I

and the summary {logdet, y'C^-1 y, 1'C^-1 y, 1'C^-1 1} of C. This covers
every SE mixture the framework uses (isotropic, anisotropic, tied) and
the EB covariance (scale = sigma2_t, shift = tau^2). On a CUDA tensor the
wrapper launches `csrc/gram_chol.cu` (K8: one small thread block per
lane on the register-tile core, each thread building and factoring one
4 x 4 tile of the Gram in registers); on a CPU tensor it runs
`fused_mix_quadratics_plain`, which performs the same operations in the
same order. The JAX package has no caller of this kernel (its EB scan
measured faster on materialized Grams); neither has the port.

A non-PD C gives NaN in that lane, never an exception.
"""
from __future__ import annotations

import torch

from ccgp_tpu_torch.ops import _build
from ccgp_tpu_torch.ops.chol_smallk import _factor_plain, _se_mix_gram_plain

MAX_N = 128     # the JAX tile
MAX_D = 16      # the JAX kernel's rate rows
_QUADS = ("logdet", "qyy", "qoy", "qoo")


def _lanes(v, b: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) parameter as a contiguous (B,) tensor like x."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if v.ndim not in (0, 1) or (v.ndim == 1 and v.shape[0] != b):
        raise ValueError(f"scale and shift must be scalars or ({b},), got "
                         f"{tuple(v.shape)}")
    return v.expand(b).contiguous()


def _check(x, y, r1, r2, p) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    if n > MAX_N:
        raise ValueError(f"n must be <= {MAX_N}")
    if d > MAX_D:
        raise ValueError(f"d must be <= {MAX_D}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {x.dtype}")
    b = r1.shape[0]
    for name, t, shape in (("y", y, (n,)), ("r1", r1, (b, d)),
                           ("r2", r2, (b, d)), ("p", p, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must match x's dtype and device")


def fused_mix_quadratics_plain(x, y, r1, r2, p, scale=1.0, shift=0.0,
                               jitter=0.0) -> dict:
    """Plain PyTorch version of `fused_mix_quadratics` (same contract): the
    SE-mixture Grams as K6's twin builds them, scale and shift, the jitter,
    then K6's right-looking factorization."""
    _check(x, y, r1, r2, p)
    b, n = r1.shape[0], x.shape[0]
    m = _se_mix_gram_plain(x, r1, r2, p, 0.0)
    m = (_lanes(scale, b, x)[:, None, None] * m
         + _lanes(shift, b, x)[:, None, None])
    if jitter:
        m = m + jitter * torch.eye(n, dtype=x.dtype, device=x.device)
    return dict(zip(_QUADS, _factor_plain(m, y)[:4]))


def fused_mix_quadratics(x, y, r1, r2, p, scale=1.0, shift=0.0,
                         jitter=0.0) -> dict:
    """{logdet, qyy, qoy, qoo} for C_b = scale_b R_mix(r1_b, r2_b, p_b)
    + shift_b J + jitter I, without materializing any Gram. x (n, d) with
    n <= 128 and d <= 16, y (n,), r1 and r2 (B, d), p (B,); scale and
    shift scalars or (B,). CUDA tensors launch `csrc/gram_chol.cu`; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_mix_quadratics_plain(x, y, r1, r2, p, scale, shift,
                                          jitter)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, y, r1, r2, p)
    (n, d), b = x.shape, r1.shape[0]
    bufs = [t.contiguous() for t in (x, y, r1, r2, p)]
    bufs += [_lanes(scale, b, x), _lanes(shift, b, x)]
    q = torch.empty((b, 4), dtype=x.dtype, device=x.device)
    if b:
        lib = _build.library()
        fn = (lib.ccgp_gram_chol_f32 if x.dtype == torch.float32
              else lib.ccgp_gram_chol_f64)
        _build.count(fused_mix_quadratics)
        _build.check(fn(*(_build.ptr(t) for t in bufs), _build.ptr(q), b, n,
                        d, float(jitter), _build.stream(x.device)),
                     "fused_mix_quadratics")
    return dict(zip(_QUADS, q.unbind(1)))


fused_mix_quadratics.launches = 0
