"""Geweke's p-value where the chain lies: one launch of `csrc/geweke.cu`
per check on the card, the plain version on the CPU.

`geweke_pvalue(samples)` is `infer.geweke.geweke_pvalue` (coda's
`geweke.diag` with `spectrum0.ar`: the least two-sided p-value over the
columns, the first 10% of the rows against the last 50%) of a window
(n, dim), or of B windows (B, n, dim) at once. On a CUDA tensor it
launches the kernel, a thread block per window, which reads each window
where it lies (any strides: the chain buffer's rows in place) and writes
one p-value per window, in the window's dtype; nothing is read back or
synchronised, and the caller reads back the p-values alone. On a CPU
tensor it runs the plain version, window by window.

The kernel sums in another order than PyTorch, so on the card the p-value
agrees with the plain version to rounding in float64 and to ~1e-5 in
float32.
"""
from __future__ import annotations

import math

import torch

from ccgp_tpu_torch.infer import geweke as plain
from ccgp_tpu_torch.ops import _build
from ccgp_tpu_torch.utils import trace

MAX_WARPS = 16
SMEM_BYTES = 232448     # the shared memory a block can opt into on sm_90
_INT_MAX = (1 << 31) - 1
_DTYPES = (torch.float32, torch.float64)


def _order_max(m: int) -> int:
    """`spectrum0_ar`'s largest AR order for a part of m rows."""
    return min(m - 1, int(10.0 * math.log10(m)))


def layout(n: int, dim: int, elem: int):
    """(n1, n2, km1, km2, warps, shared bytes) of a window of n rows and dim
    columns of `elem`-byte floats: the parts' lengths (the first 10% of
    the rows and the last 50%) and largest AR orders, as `infer.geweke`
    takes them, then a warp per (part, column) problem, at most MAX_WARPS,
    each with its own slice of shared memory (the part's column, c, v, s
    and phi), and the columns' means and spectra. Raises ValueError where
    a part is empty or one warp's slice does not fit."""
    n1, n2 = int(0.1 * n), int(0.5 * n)
    if n1 < 1:
        raise ValueError(f"geweke_pvalue needs both parts non-empty: n = {n}"
                         f" gives {n1} and {n2} rows")
    km1, km2 = _order_max(n1), _order_max(n2)
    per_warp = max(n1, n2) + 4 * (max(km1, km2) + 1)
    fixed = 4 * dim
    warps = min(2 * dim, MAX_WARPS, (SMEM_BYTES // elem - fixed) // per_warp)
    if warps < 1:
        raise ValueError(f"a window of {n} rows and {dim} columns does not "
                         f"fit one block's shared memory")
    return n1, n2, km1, km2, warps, (warps * per_warp + fixed) * elem


def _on_cpu(samples: torch.Tensor) -> bool:
    return samples.device.type == "cpu"


def geweke_pvalue(samples: torch.Tensor) -> torch.Tensor:
    """The Geweke p-value of a window (n, dim), a 0-dim tensor, or of B
    windows (B, n, dim), a (B,) tensor, on the windows' device: ONE launch
    of `csrc/geweke.cu` on a CUDA tensor (counted as `geweke.kernel` on
    the open span), `infer.geweke.geweke_pvalue` on a CPU one."""
    if _on_cpu(samples):
        if samples.ndim == 3:
            return torch.stack([plain.geweke_pvalue(w) for w in samples])
        return plain.geweke_pvalue(samples)
    if samples.dtype not in _DTYPES:
        raise TypeError(f"geweke_pvalue takes float32 or float64 windows, "
                        f"got {samples.dtype}")
    if samples.ndim not in (2, 3):
        raise ValueError(f"geweke_pvalue takes a window (n, dim) or windows "
                         f"(B, n, dim), got shape {tuple(samples.shape)}")
    wins = samples if samples.ndim == 3 else samples[None]
    B, n, dim = wins.shape
    if B < 1 or dim < 1 or max(B, n, dim) > _INT_MAX:
        raise ValueError(f"geweke_pvalue needs 1 to 2**31 - 1 windows and "
                         f"columns, got shape {tuple(samples.shape)}")
    n1, n2, km1, km2, warps, _ = layout(n, dim, samples.element_size())
    if samples.device.type != "cuda":
        raise ValueError(f"unsupported device {samples.device}")
    out = torch.empty(B, dtype=samples.dtype, device=samples.device)
    lib = _build.library()
    fn = (lib.ccgp_geweke_f32 if samples.dtype == torch.float32
          else lib.ccgp_geweke_f64)
    ws, ld, cs = wins.stride()
    _build.count(geweke_pvalue)
    trace.count("geweke.kernel")
    _build.check(fn(_build.ptr(wins), _build.ptr(out), ws, ld, cs, B, n, dim,
                    n1, n2, km1, km2, warps, _build.stream(samples.device)),
                 "geweke_pvalue")
    return out if samples.ndim == 3 else out[0]


geweke_pvalue.launches = 0
