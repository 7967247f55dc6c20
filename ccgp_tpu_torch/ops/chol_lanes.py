"""Batched Cholesky with the forward solve of [y, 1] fused in (port of
`ccgp_tpu/ops/pallas_chol_lanes.py`).

For a batch of Grams (B, n, n), n <= 128, and one right-hand side y (n,),
each matrix is factored by a right-looking loop over its pivots; pivot j
also forms row j of W = L^-1 [y, 1] and downdates the right-hand sides.

  chol_quadratics_lanes  {logdet, qyy = y'R^-1 y, qoy = 1'R^-1 y,
                          qoo = 1'R^-1 1}                         (K3)
  chol_factors_lanes     the same plus chol (B, n, n) lower,
                         wy = L^-1 y and wo = L^-1 1 (B, n)       (K4)

Only the lower triangle of each Gram is read; the entries above the
diagonal do not change any output. The jitter is absolute (added to the
diagonal). On a CUDA tensor each wrapper launches `csrc/chol_lanes.cu`
(`lanes_layout` says how: up to n = 32 a matrix per group of 8, 16 or 32
lanes of a warp, in registers; beyond, a thread block per matrix on the
register-tile core); on a CPU tensor it runs `_factor_plain`, which
performs the same operations in the same order. Unlike the JAX package,
nothing is padded to 128: the
identity blocks it pads with add 0 to the log-determinant and the
quadratics, so the first B results are the same.

A non-PD matrix gives NaN (the square root of a negative pivot), never an
exception.
"""
from __future__ import annotations

import ctypes

import torch

from ccgp_tpu_torch.ops import _build

MAX_N = 128       # the largest n either kernel takes (the JAX tile)
MIN_BATCH = 64    # the dispatchers send batches this large to the kernels


def dispatch_ok(b: int, n: int) -> bool:
    """The JAX package's routing rule for the lanes kernels (B >= 64,
    n <= 128), without its test of the backend."""
    return b >= MIN_BATCH and n <= MAX_N


def lanes_layout(n: int, b: int, dtype) -> tuple[int, int, int]:
    """Both kernels' launch for B matrices of n x n as `csrc/chol_lanes.cu`
    lays it out: (lanes per matrix on the warp path, 0 on the tile path;
    threads per block; blocks). Needs the kernel library."""
    group, threads, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    elem = torch.empty((), dtype=dtype).element_size()
    _build.check(_build.library().ccgp_chol_lanes_layout(
        n, b, elem, ctypes.addressof(group), ctypes.addressof(threads),
        ctypes.addressof(blocks)), "chol_lanes layout")
    return group.value, threads.value, blocks.value


def _check(grams: torch.Tensor, y: torch.Tensor) -> None:
    if grams.ndim != 3 or grams.shape[1] != grams.shape[2]:
        raise ValueError(f"grams must be (B, n, n), got {tuple(grams.shape)}")
    n = grams.shape[-1]
    if n > MAX_N:
        raise ValueError(f"n must be <= {MAX_N}, got {n}")
    if grams.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {grams.dtype}")
    if y.shape != (n,):
        raise ValueError(f"y has shape {tuple(y.shape)}, expected ({n},)")
    if y.dtype != grams.dtype or y.device != grams.device:
        raise TypeError("y must match grams' dtype and device")


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tensors)
# ---------------------------------------------------------------------------

def _factor_plain(grams: torch.Tensor, y: torch.Tensor, jitter) -> dict:
    """Right-looking Cholesky of every matrix with the forward solve of
    [y, 1] fused in; the quadratics accumulate pivot by pivot."""
    b, n, _ = grams.shape
    a = grams.clone()
    if jitter:
        a = a + jitter * torch.eye(n, dtype=a.dtype, device=a.device)
    ry = y.expand(b, n).clone()
    ro = torch.ones_like(ry)
    wy = torch.zeros_like(ry)
    wo = torch.zeros_like(ry)
    d = torch.zeros_like(ry)
    ld = torch.zeros(b, dtype=a.dtype, device=a.device)
    qyy = torch.zeros_like(ld)
    qoy = torch.zeros_like(ld)
    qoo = torch.zeros_like(ld)
    for j in range(n):
        dj = torch.sqrt(a[:, j, j])
        col = a[:, j + 1:, j] / dj[:, None]
        wyj = ry[:, j] / dj
        woj = ro[:, j] / dj
        ld = ld + 2.0 * torch.log(dj)
        qyy = qyy + wyj * wyj
        qoy = qoy + wyj * woj
        qoo = qoo + woj * woj
        ry[:, j + 1:] = ry[:, j + 1:] - col * wyj[:, None]
        ro[:, j + 1:] = ro[:, j + 1:] - col * woj[:, None]
        a[:, j + 1:, j + 1:] = (a[:, j + 1:, j + 1:]
                                - col[:, :, None] * col[:, None, :])
        wy[:, j] = wyj
        wo[:, j] = woj
        d[:, j] = dj
    # column c below the diagonal is final after pivot c - 1: L = it / d_c
    below = torch.ones(n, n, dtype=torch.bool, device=a.device).tril(-1)
    chol = (torch.where(below, a / d[:, None, :], torch.zeros_like(a))
            + torch.diag_embed(d))
    return {"chol": chol, "wy": wy, "wo": wo, "logdet": ld, "qyy": qyy,
            "qoy": qoy, "qoo": qoo}


_QUADS = ("logdet", "qyy", "qoy", "qoo")


def chol_quadratics_lanes_plain(grams: torch.Tensor, y: torch.Tensor,
                                jitter=0.0) -> dict:
    """Plain PyTorch version of `chol_quadratics_lanes` (same contract)."""
    _check(grams, y)
    f = _factor_plain(grams, y, jitter)
    return {k: f[k] for k in _QUADS}


def chol_factors_lanes_plain(grams: torch.Tensor, y: torch.Tensor,
                             jitter=0.0) -> dict:
    """Plain PyTorch version of `chol_factors_lanes` (same contract)."""
    _check(grams, y)
    return _factor_plain(grams, y, jitter)


# ---------------------------------------------------------------------------
# the wrappers (replace the Pallas kernels chol_quadratics_lanes and
# chol_factors_lanes)
# ---------------------------------------------------------------------------

def _outputs(grams: torch.Tensor, factors: bool):
    b, n, _ = grams.shape
    dt, dev = grams.dtype, grams.device
    q = torch.empty((b, 4), dtype=dt, device=dev)
    if not factors:
        return q, None, None, None
    return (q, torch.empty((b, n, n), dtype=dt, device=dev),
            torch.empty((b, n), dtype=dt, device=dev),
            torch.empty((b, n), dtype=dt, device=dev))


def _launch(grams, y, jitter, q, chol, wy, wo) -> None:
    b, n, _ = grams.shape
    lib = _build.library()
    fn = (lib.ccgp_chol_lanes_f32 if grams.dtype == torch.float32
          else lib.ccgp_chol_lanes_f64)
    _build.check(fn(_build.ptr(grams), _build.ptr(y), _build.ptr(q),
                    _build.ptr(chol), _build.ptr(wy), _build.ptr(wo),
                    b, n, int(chol is not None), float(jitter),
                    _build.stream(grams.device)), "chol_lanes")


def _device_of(grams: torch.Tensor) -> str:
    if grams.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {grams.device}")
    return grams.device.type


def chol_quadratics_lanes(grams: torch.Tensor, y: torch.Tensor,
                          jitter=0.0) -> dict:
    """Batched {logdet, qyy, qoy, qoo} for grams (B, n, n), n <= 128, with
    an absolute diagonal jitter. CUDA tensors launch `csrc/chol_lanes.cu`
    with the factor output off (`lanes_layout`); CPU tensors take the
    plain version."""
    if _device_of(grams) == "cpu":
        return chol_quadratics_lanes_plain(grams, y, jitter)
    _check(grams, y)
    grams, y = grams.contiguous(), y.contiguous()
    q, _, _, _ = _outputs(grams, factors=False)
    if grams.shape[0]:
        _build.count(chol_quadratics_lanes)
        _launch(grams, y, jitter, q, None, None, None)
    return {k: q[:, i] for i, k in enumerate(_QUADS)}


def chol_factors_lanes(grams: torch.Tensor, y: torch.Tensor,
                       jitter=0.0) -> dict:
    """Batched factor cache {chol (B, n, n) lower, wy = L^-1 y, wo = L^-1 1
    (B, n), logdet, qyy, qoy, qoo}. CUDA tensors launch
    `csrc/chol_lanes.cu` with the factor output on (`lanes_layout`); CPU
    tensors take the plain version."""
    if _device_of(grams) == "cpu":
        return chol_factors_lanes_plain(grams, y, jitter)
    _check(grams, y)
    grams, y = grams.contiguous(), y.contiguous()
    q, chol, wy, wo = _outputs(grams, factors=True)
    if grams.shape[0]:
        _build.count(chol_factors_lanes)
        _launch(grams, y, jitter, q, chol, wy, wo)
    out = {"chol": chol, "wy": wy, "wo": wo}
    out.update({k: q[:, i] for i, k in enumerate(_QUADS)})
    return out


chol_quadratics_lanes.launches = 0
chol_factors_lanes.launches = 0
