"""The per-matrix Cholesky + profile-NLL kernel (port of
`ccgp_tpu/ops/pallas_chol.py:107-233`, `_chol_nll_pallas` with its default
blocked body), reached through `ops.chol.chol_quadratics(use_pallas=True)`.

For a batch of Grams (B, n, n), n <= 128, and one right-hand side y (n,),
each matrix is factored by LEFT-looking panels of 8 columns (each panel is
first downdated by every finished column, then factored column by column),
and only then is W = L^-1 [y, 1] formed by a forward substitution over the
same panels:

  chol_nll  {logdet = 2 sum log L_jj, qyy = |W_y|^2, qoy = W_y . W_o,
             qoo = |W_o|^2}                                        (K9)

The jitter is absolute (added to the diagonal before factoring). Only the
lower triangle of each Gram is read. On a CUDA tensor the wrapper launches
`csrc/chol_nll.cu` (one thread block per matrix); on a CPU tensor it runs
`chol_nll_plain`, which performs the same operations in the same order.
Nothing is padded to 128: the JAX package's identity padding adds 0 to
every output. A non-PD matrix gives NaN on that matrix, never an exception.
"""
from __future__ import annotations

import torch

from ccgp_tpu_torch.ops import _build
from ccgp_tpu_torch.ops.chol_lanes import _check   # the same contract as K3

PANEL = 8       # the JAX kernel's panel width
_QUADS = ("logdet", "qyy", "qoy", "qoo")


def chol_nll_plain(grams: torch.Tensor, y: torch.Tensor, jitter=0.0) -> dict:
    """Plain PyTorch version of `chol_nll` (same contract): the panels,
    their downdates (sums accumulated column by column), the in-panel
    recursion, the blocked forward substitution and the row-order sums of
    the kernel."""
    _check(grams, y)
    b, n, _ = grams.shape
    dt, dev = grams.dtype, grams.device
    a = torch.tril(grams)
    if jitter:
        a = a + jitter * torch.eye(n, dtype=dt, device=dev)
    L = torch.zeros_like(a)
    for r0 in range(0, n, PANEL):
        nb = min(PANEL, n - r0)
        slab = a[:, r0:, r0:r0 + nb].clone()           # rows r0.., the panel
        if r0:
            acc = torch.zeros_like(slab)
            for c in range(r0):
                acc = acc + L[:, r0:, c, None] * L[:, None, r0:r0 + nb, c]
            slab = slab - acc
        for j in range(nb):
            p = r0 + j
            d = torch.sqrt(slab[:, j, j])
            col = slab[:, j + 1:, j] / d[:, None]      # rows p+1..n-1
            L[:, p, p] = d
            L[:, p + 1:, p] = col
            if j + 1 < nb:
                slab[:, j + 1:, j + 1:] = (slab[:, j + 1:, j + 1:]
                                           - col[:, :, None]
                                           * col[:, None, :nb - j - 1])
    rhs = torch.stack([y, torch.ones_like(y)], dim=-1).expand(b, n, 2)
    w = torch.zeros((b, n, 2), dtype=dt, device=dev)
    for r0 in range(0, n, PANEL):
        nb = min(PANEL, n - r0)
        blk = rhs[:, r0:r0 + nb, :]
        if r0:
            acc = torch.zeros_like(blk)
            for c in range(r0):
                acc = acc + L[:, r0:r0 + nb, c, None] * w[:, c, None, :]
            blk = blk - acc
        for j in range(nb):
            p = r0 + j
            acc = torch.zeros((b, 2), dtype=dt, device=dev)
            for c in range(r0, p):
                acc = acc + L[:, p, c, None] * w[:, c, :]
            w[:, p, :] = (blk[:, j, :] - acc) / L[:, p, p, None]
    ld = torch.zeros(b, dtype=dt, device=dev)
    q = torch.zeros((b, 3), dtype=dt, device=dev)
    for p in range(n):
        wy, wo = w[:, p, 0], w[:, p, 1]
        ld = ld + torch.log(L[:, p, p])
        q = q + torch.stack([wy * wy, wy * wo, wo * wo], dim=-1)
    return dict(zip(_QUADS, (2.0 * ld, q[:, 0], q[:, 1], q[:, 2])))


def chol_nll(grams: torch.Tensor, y: torch.Tensor, jitter=0.0) -> dict:
    """Batched {logdet, qyy, qoy, qoo} for grams (B, n, n), n <= 128, with
    an absolute diagonal jitter. CUDA tensors launch `csrc/chol_nll.cu`;
    CPU tensors take the plain version."""
    if grams.device.type == "cpu":
        return chol_nll_plain(grams, y, jitter)
    if grams.device.type != "cuda":
        raise ValueError(f"unsupported device {grams.device}")
    _check(grams, y)
    b, n, _ = grams.shape
    grams, y = grams.contiguous(), y.contiguous()
    q = torch.empty((b, 4), dtype=grams.dtype, device=grams.device)
    if b:
        lib = _build.library()
        fn = (lib.ccgp_chol_nll_f32 if grams.dtype == torch.float32
              else lib.ccgp_chol_nll_f64)
        _build.count(chol_nll)
        _build.check(fn(_build.ptr(grams), _build.ptr(y), _build.ptr(q), b,
                        n, float(jitter), _build.stream(grams.device)),
                     "chol_nll")
    return dict(zip(_QUADS, q.unbind(1)))


chol_nll.launches = 0
