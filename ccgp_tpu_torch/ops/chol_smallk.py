"""The small-K latency kernels (port of
`ccgp_tpu/ops/pallas_chol_smallk.py`): K <= 16 matrices factored in one
launch, each a right-looking Cholesky with the forward solve of [y, 1]
fused in and logdet and the quadratics accumulated in pivot order (K1 and
K5-K7 at n <= 128 on the register-tile core `csrc/tile_core.cuh`; K5 and
K6 beyond on a panel core over a thread-block cluster; K7 and K1 beyond
128 on `csrc/chol_core.cuh`). Four wrappers, each with its plain
PyTorch twin (the same operations in the same order) and a launch counter:

  chol_quadratics_smallk       K5  {logdet, qyy, qoy, qoo} of K
                                   materialized Grams (lower triangle
                                   read) + jitter I       csrc/chol_smallk.cu
  fused_mix_quadratics_smallk  K6  the same for the SE-mixture Gram built
                                   in the kernel from x, r1, r2, p
  fused_mix_mh_round           K7  K6, the log-posteriors from the passed
                                   extra and log_scale, and the first-
                                   acceptance scan: one speculative round
  fused_mix_mh_rounds          K1  R whole rounds with the candidate model
                                   in the kernel, and the stash
                                                          csrc/mh_rounds.cu

`fused_mix_mh_rounds` runs R whole speculative rounds of the SE-mixture
sampler. Per round, for each of K candidates z + delta: the candidate
model (transform, Jacobian, priors; `CandModel`), the SE-mixture Gram
built from x as sum_k r_k (x_ik - x_jk)^2, the factorization, the
log-posterior; then the first-acceptance scan (a NaN log-posterior
compares False and so rejects) and the state carry.

On a CUDA tensor each wrapper launches its kernel (`smallk_layout` and
`rounds_layout` say how): K5 and K6 (one layout) a block per matrix up to
n = 128 and a cluster of 8 or 16 blocks per matrix beyond; K7 up to
n = 128 one cluster of min(K, 8) blocks, a block per candidate, and
beyond 128 one thread block for all K matrices; K1 one cluster of
min(K, 8) blocks for all R rounds, each block factoring its own
candidates. On a CPU tensor it
runs its twin. A non-PD matrix gives NaN quadratics, never an exception.

The stash layout is the port's own: (R, n+2, n), row j < n holding
L[i, j] at column i >= j (zeros below), row n L^-1 y and row n+1 L^-1 1 of
the round's accepted candidate; rows of rejected rounds are NaN. Decode
with `predict.factors.decode_stash` (tril of the transpose, as in JAX).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ccgp_tpu_torch.ops import _build
from ccgp_tpu_torch.utils import transforms

TILE = 128
MAX_N = 1024
DISPATCH_BUDGET = 256
MAX_K = 16      # candidates per round the kernel holds
MAX_D = TILE    # input dimensions the kernels hold, as in JAX
_LOG2PI = math.log(2.0 * math.pi)

# prior codes shared with csrc/mh_rounds.cu
PRIOR_NONE, PRIOR_INVGAMMA, PRIOR_LOGNORMAL, PRIOR_UNIFORM01, \
    PRIOR_JEFFREYS = range(5)


def rounds_layout(n: int, k: int) -> tuple[int, int]:
    """K1's launch for n points and K candidates as `csrc/mh_rounds.cu`
    lays it out: (thread blocks in its cluster, min(K, 8); elements of
    the global workspace it takes, 0 for none). Needs the kernel library."""
    blocks, elems = ctypes.c_int(), ctypes.c_longlong()
    _build.check(_build.library().ccgp_mh_rounds_layout(
        n, k, ctypes.addressof(blocks), ctypes.addressof(elems)),
        "fused_mix_mh_rounds layout")
    return blocks.value, elems.value


def dispatch_ok(n: int, k: int) -> bool:
    """True inside the JAX package's small-K dispatch envelope (n <= 1024,
    K <= 16, K * tiles^2 <= 256 with 128-wide tiles). The port keeps the
    envelope so that it routes exactly as JAX does."""
    tiles = -(-n // TILE)
    return (n <= MAX_N and k <= MAX_K
            and k * tiles * tiles <= DISPATCH_BUDGET)


class CandModel(ctypes.Structure):
    """The candidate model as a small parameter struct (the JAX kernel's
    `cand_model` closure, `ccgp_tpu/models/likelihood.py:349-411`):
    anisotropic or isotropic rates over `ndim` input axes, tied (rough
    rate (1 + lambda) theta1) or direct rough rate, and for theta1,
    theta2 and p a prior code with its two parameters."""

    _fields_ = [("anisotropic", ctypes.c_int),
                ("ndim", ctypes.c_int),
                ("tied", ctypes.c_int),
                ("prior_code", ctypes.c_int * 3),
                ("prior_a", ctypes.c_double * 3),
                ("prior_b", ctypes.c_double * 3)]

    @classmethod
    def make(cls, anisotropic: bool, ndim: int, tied: bool, priors):
        """priors: three (code, a, b) for theta1, theta2 and p."""
        m = cls()
        m.anisotropic, m.ndim, m.tied = int(anisotropic), int(ndim), int(tied)
        for i, (code, a, b) in enumerate(priors):
            m.prior_code[i] = int(code)
            m.prior_a[i] = float(a)
            m.prior_b[i] = float(b)
        return m

    @property
    def dim(self) -> int:
        """Length of the unconstrained state z."""
        return self.ndim + 2 if self.anisotropic else 3


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tensors)
# ---------------------------------------------------------------------------

def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A constant on like's device: PyTorch divides by a CPU scalar as a
    multiply by its reciprocal, the kernel divides."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _prior(code: int, a: float, b: float, x):
    if code == PRIOR_INVGAMMA:
        return -(a + 1.0) * torch.log(x) - _const(b, x) / x
    if code == PRIOR_LOGNORMAL:
        lx = torch.log(x)
        t = (lx - a) / _const(b, x)
        return -lx - 0.5 * (t * t)
    if code == PRIOR_UNIFORM01:
        return torch.zeros_like(x)
    if code == PRIOR_JEFFREYS:
        return -0.5 * (torch.log(x) + torch.log1p(-x))
    raise ValueError(f"unknown prior code {code}")


def cand_model_plain(model: CandModel, cz: torch.Tensor, s2):
    """Candidates cz (K, dim) -> (r1 (K, d), r2 (K, d), p (K,),
    extra = log-Jacobian + log-prior (K,), log_scale (K,))."""
    d = model.ndim
    kk = cz.shape[0]
    if model.anisotropic:
        r1 = torch.exp(cz[:, :d])
        psi_sum = cz[:, 0]
        for a in range(1, d):
            psi_sum = psi_sum + cz[:, a]
        phi, zeta = cz[:, d], cz[:, d + 1]
        th2 = torch.exp(zeta)
        p = transforms.sigmoid(phi)
        log_jac = (psi_sum + zeta) + (transforms.log_sigmoid(phi)
                                      + transforms.log_sigmoid(-phi))
        theta1 = None
    else:
        psi1, psi2, phi = cz[:, 0], cz[:, 1], cz[:, 2]
        theta1 = torch.exp(psi1)
        th2 = torch.exp(psi2)
        p = transforms.sigmoid(phi)
        log_jac = (psi1 + psi2) + (transforms.log_sigmoid(phi)
                                   + transforms.log_sigmoid(-phi))
        r1 = theta1[:, None].expand(kk, d)
    if model.tied:
        r2 = (1.0 + th2)[:, None] * r1
    else:
        r2 = th2[:, None].expand(kk, d)
    log_prior = torch.zeros_like(log_jac)
    code, pa, pb = model.prior_code, model.prior_a, model.prior_b
    if code[0]:
        if model.anisotropic:
            lp1 = _prior(code[0], pa[0], pb[0], r1[:, 0])
            for a in range(1, d):
                lp1 = lp1 + _prior(code[0], pa[0], pb[0], r1[:, a])
        else:
            lp1 = _prior(code[0], pa[0], pb[0], theta1)
        log_prior = log_prior + lp1
    if code[1]:
        log_prior = log_prior + _prior(code[1], pa[1], pb[1], th2)
    if code[2]:
        log_prior = log_prior + _prior(code[2], pa[2], pb[2], p)
    extra = log_jac + log_prior
    s = p * p + (1.0 - p) * (1.0 - p)
    return r1, r2, p, extra, torch.log(s * s2)


def _se_mix_gram_plain(x, r1, r2, p, jitter):
    """The K SE-mixture Grams (K, n, n) as the kernels build them:
    (p^2 e^-D1 + (1-p)^2 e^-D2) / (p^2 + (1-p)^2), D_i = sum_a r_i[a]
    (x_a - x'_a)^2 accumulated axis by axis, plus jitter on the diagonal."""
    n, d = x.shape
    kk = r1.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    d2 = diff * diff                                    # (n, n, d)
    dist1 = torch.zeros((kk, n, n), dtype=x.dtype, device=x.device)
    dist2 = torch.zeros_like(dist1)
    for a in range(d):
        dist1 = dist1 + d2[:, :, a] * r1[:, a, None, None]
        dist2 = dist2 + d2[:, :, a] * r2[:, a, None, None]
    w1 = (p * p)[:, None, None]
    w2 = ((1.0 - p) * (1.0 - p))[:, None, None]
    m = (w1 * torch.exp(-dist1) + w2 * torch.exp(-dist2)) / (w1 + w2)
    if jitter:
        m = m + jitter * torch.eye(n, dtype=x.dtype, device=x.device)
    return m


def _factor_plain(m: torch.Tensor, y: torch.Tensor):
    """Right-looking Cholesky of K symmetric matrices m (K, n, n) with the
    forward solve of [y, 1] fused in; the same unnormalized downdate as
    the kernel (`_chol_quad_core_shrink` in JAX). Returns logdet, the
    quadratics (accumulated pivot by pivot), L (K, n, n), L^-1 y, L^-1 1."""
    kk, n, _ = m.shape
    m = m.clone()
    ry = y.expand(kk, n).clone()
    ro = torch.ones_like(ry)
    wy = torch.zeros_like(ry)
    wo = torch.zeros_like(ry)
    dinvs = torch.zeros_like(ry)
    ld = torch.zeros(kk, dtype=m.dtype, device=m.device)
    qyy = torch.zeros_like(ld)
    qoy = torch.zeros_like(ld)
    qoo = torch.zeros_like(ld)
    for j in range(n):
        dj = m[:, j, j]
        dinv = torch.rsqrt(dj)
        ld = ld + torch.log(dj)
        wyj = ry[:, j] * dinv
        woj = ro[:, j] * dinv
        if j + 1 < n:
            l = m[:, j, j + 1:] * dinv[:, None]
            m[:, j + 1:, j + 1:] = (m[:, j + 1:, j + 1:]
                                    - l[:, :, None] * l[:, None, :])
            ry[:, j + 1:] = ry[:, j + 1:] - l * wyj[:, None]
            ro[:, j + 1:] = ro[:, j + 1:] - l * woj[:, None]
        wy[:, j] = wyj
        wo[:, j] = woj
        dinvs[:, j] = dinv
        qyy = qyy + wyj * wyj
        qoy = qoy + wyj * woj
        qoo = qoo + woj * woj
    # row j of the downdated upper triangle scaled by d_j^{-1/2} is L[:, j]
    chol = torch.triu(m) * dinvs[:, :, None]
    return ld, qyy, qoy, qoo, chol.transpose(-1, -2), wy, wo


def fused_mix_mh_rounds_plain(x, y, z, lp_val, lp_beta, sigma2, deltas,
                              log_u, model: CandModel, jitter: float = 0.0,
                              stash: bool = False) -> dict:
    """Plain PyTorch version of `fused_mix_mh_rounds` (same contract)."""
    n = x.shape[0]
    rr, kk = log_u.shape
    dim = deltas.shape[1]
    dt, dev = x.dtype, x.device
    zc = z.clone()
    lpv = torch.as_tensor(lp_val, dtype=dt, device=dev).reshape(())
    lpb = torch.as_tensor(lp_beta, dtype=dt, device=dev).reshape(())
    s2 = torch.as_tensor(sigma2, dtype=dt, device=dev).reshape(())
    recs, accs, cons, stashes = [], [], [], []
    for r in range(rr):
        cz = zc[None, :] + deltas[r * kk:(r + 1) * kk]
        r1, r2, p, extra, log_scale = cand_model_plain(model, cz, s2)
        m = _se_mix_gram_plain(x, r1, r2, p, jitter)
        ld, qyy, qoy, qoo, chol, wy, wo = _factor_plain(m, y)
        beta = qoy / qoo
        quad = qyy - qoy * qoy / qoo
        val = (-0.5 * (n * _LOG2PI + ld + n * log_scale
                       + quad * torch.exp(-log_scale)) + extra)
        acc = (val - lpv) > log_u[r]
        any_acc = acc.any()
        first = torch.argmax(acc.to(torch.int32))
        sel = torch.where(any_acc, first, 0)
        zc = torch.where(any_acc, cz[sel], zc)
        lpv = torch.where(any_acc, val[sel], lpv)
        lpb = torch.where(any_acc, beta[sel], lpb)
        recs.append(torch.cat([zc, lpb[None], lpv[None]]))
        accs.append(any_acc)
        cons.append(torch.where(any_acc, first + 1, kk).to(torch.int32))
        if stash:
            rows = torch.cat([chol[sel].transpose(0, 1), wy[sel][None],
                              wo[sel][None]])
            stashes.append(torch.where(any_acc, rows,
                                       torch.full_like(rows, float("nan"))))
    rec = torch.stack(recs)
    out = {"rec": rec, "acc": torch.stack(accs),
           "consumed": torch.stack(cons), "z_fin": rec[-1, :dim],
           "beta_fin": rec[-1, dim], "val_fin": rec[-1, dim + 1]}
    if stash:
        out["stash"] = torch.stack(stashes)
    return out


# ---------------------------------------------------------------------------
# the wrapper (replaces the Pallas kernel fused_mix_mh_rounds)
# ---------------------------------------------------------------------------

def _check(x, y, z, deltas, log_u, model: CandModel):
    n, d = x.shape
    rk, dim = deltas.shape
    rr, kk = log_u.shape
    if rk != rr * kk:
        raise ValueError(f"deltas has {rk} rows, expected R*K = {rr * kk}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {x.dtype}")
    for name, t, shape in (("y", y, (n,)), ("z", z, (dim,)),
                           ("deltas", deltas, (rk, dim)),
                           ("log_u", log_u, (rr, kk))):
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must match x's dtype and device")
    if model.ndim != d or model.dim != dim:
        raise ValueError(f"candidate model (ndim={model.ndim}, "
                         f"dim={model.dim}) does not fit x ({d}) / z ({dim})")
    if not dispatch_ok(n, kk):
        raise ValueError(f"(n={n}, K={kk}) is outside the dispatch "
                         f"envelope (see dispatch_ok)")
    if d > MAX_D:
        raise ValueError(f"d must be <= {MAX_D}")


def fused_mix_mh_rounds(x, y, z, lp_val, lp_beta, sigma2, deltas, log_u,
                        model: CandModel, jitter: float = 0.0,
                        stash: bool = False) -> dict:
    """R speculative Metropolis rounds. Returns a dict:

      rec       (R, dim+2) per-round post-state rows [z | beta | logpost]
      acc       (R,) bool per-round acceptance
      consumed  (R,) int32 proposals consumed per round
      z_fin (dim,), val_fin, beta_fin: the state after all R rounds
      stash     (R, n+2, n) factors of each round's accepted candidate
                (see the module docstring), when stash=True

    CUDA tensors launch `csrc/mh_rounds.cu`, one cluster of min(K, 8)
    thread blocks (`rounds_layout`); CPU tensors take
    `fused_mix_mh_rounds_plain`."""
    _check(x, y, z, deltas, log_u, model)
    if x.device.type == "cpu":
        return fused_mix_mh_rounds_plain(x, y, z, lp_val, lp_beta, sigma2,
                                         deltas, log_u, model, jitter, stash)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    rr, kk = log_u.shape
    dim = deltas.shape[1]
    dt, dev = x.dtype, x.device
    st = torch.stack([torch.as_tensor(v, dtype=dt, device=dev).reshape(())
                      for v in (lp_val, lp_beta, sigma2)])
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    deltas, log_u = deltas.contiguous(), log_u.contiguous()
    rec = torch.empty((rr, dim + 2), dtype=dt, device=dev)
    info = torch.empty((rr, 2), dtype=torch.int32, device=dev)
    st_out = (torch.full((rr, n + 2, n), float("nan"), dtype=dt, device=dev)
              if stash else None)
    # beyond one tile each block of the cluster factors its candidates in
    # its own slice of this workspace when they do not fit its shared memory
    ws_elems = rounds_layout(n, kk)[1]
    ws = (torch.empty(ws_elems, dtype=dt, device=dev) if ws_elems > 0
          else None)
    lib = _build.library()
    fn = (lib.ccgp_mh_rounds_f32 if dt == torch.float32
          else lib.ccgp_mh_rounds_f64)
    _build.count(fused_mix_mh_rounds)
    _build.check(fn(_build.ptr(x), _build.ptr(y), _build.ptr(z),
                    _build.ptr(st), _build.ptr(deltas), _build.ptr(log_u),
                    _build.ptr(rec), _build.ptr(info), _build.ptr(st_out),
                    _build.ptr(ws), ctypes.addressof(model),
                    n, d, dim, rr, kk, float(jitter),
                    _build.stream(dev)), "fused_mix_mh_rounds")
    out = {"rec": rec, "acc": info[:, 0] > 0, "consumed": info[:, 1],
           "z_fin": rec[-1, :dim], "beta_fin": rec[-1, dim],
           "val_fin": rec[-1, dim + 1]}
    if stash:
        out["stash"] = st_out
    return out


fused_mix_mh_rounds.launches = 0


# ---------------------------------------------------------------------------
# K5, K6, K7: one factorization of K matrices per launch
# (csrc/chol_smallk.cu)
# ---------------------------------------------------------------------------

_QUADS = ("logdet", "qyy", "qoy", "qoo")


def _quads(ld, qyy, qoy, qoo) -> dict:
    return dict(zip(_QUADS, (ld, qyy, qoy, qoo)))


def _same(name, t, like, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != like.dtype or t.device != like.device:
        raise TypeError(f"{name} must match the first input's dtype and "
                        f"device")


def _check_envelope(n: int, kk: int, dtype) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    if kk < 1 or not dispatch_ok(n, kk):
        raise ValueError(f"(n={n}, K={kk}) is outside the dispatch envelope "
                         f"(see dispatch_ok)")


def _check_grams(grams, y) -> None:
    if grams.ndim != 3 or grams.shape[1] != grams.shape[2]:
        raise ValueError(f"grams must be (K, n, n), got {tuple(grams.shape)}")
    kk, n, _ = grams.shape
    _check_envelope(n, kk, grams.dtype)
    _same("y", y, grams, (n,))


def _check_mix(x, y, r1, r2, p) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    kk = r1.shape[0]
    _check_envelope(n, kk, x.dtype)
    if d > MAX_D:
        raise ValueError(f"d must be <= {MAX_D}")
    for name, t, shape in (("y", y, (n,)), ("r1", r1, (kk, d)),
                           ("r2", r2, (kk, d)), ("p", p, (kk,))):
        _same(name, t, x, shape)


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


_SMALLK_KERNELS = ("chol_quadratics_smallk", "fused_mix_quadratics_smallk",
                   "fused_mix_mh_round")


def smallk_layout(kernel: str, n: int, k: int,
                  dtype) -> tuple[int, int, int]:
    """K5's, K6's or K7's launch for n and K as `csrc/chol_smallk.cu` lays
    it out: (thread blocks per cluster, 1 for none; thread blocks in all;
    elements of the global workspace it takes, 0 for none). K5 and K6 take
    the same layout. Needs the kernel library."""
    cluster, blocks = ctypes.c_int(), ctypes.c_int()
    elems = ctypes.c_longlong()
    elem = torch.empty((), dtype=dtype).element_size()
    _build.check(_build.library().ccgp_smallk_layout(
        _SMALLK_KERNELS.index(kernel), n, k, elem, ctypes.addressof(cluster),
        ctypes.addressof(blocks), ctypes.addressof(elems)), f"{kernel} layout")
    return cluster.value, blocks.value, elems.value


def _workspace(kernel: str, n: int, kk: int, like: torch.Tensor):
    """The global workspace `smallk_layout` asks for, or None."""
    elems = smallk_layout(kernel, n, kk, like.dtype)[2]
    return (torch.empty(elems, dtype=like.dtype, device=like.device)
            if elems > 0 else None)


def _lib_fn(name: str, dtype):
    lib = _build.library()
    return getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def _lower_with_jitter(grams: torch.Tensor, jitter) -> torch.Tensor:
    """The matrices K5 factors: each Gram's lower triangle mirrored (the
    upper triangle is never read) plus jitter on the diagonal."""
    n = grams.shape[-1]
    low = torch.ones(n, n, dtype=torch.bool, device=grams.device).tril()
    m = torch.where(low, grams, grams.transpose(-1, -2))
    if jitter:
        m = m + jitter * torch.eye(n, dtype=grams.dtype, device=grams.device)
    return m


def chol_quadratics_smallk_plain(grams, y, jitter=0.0) -> dict:
    """Plain PyTorch version of `chol_quadratics_smallk` (same contract)."""
    _check_grams(grams, y)
    return _quads(*_factor_plain(_lower_with_jitter(grams, jitter), y)[:4])


def chol_quadratics_smallk(grams, y, jitter=0.0) -> dict:
    """{logdet, qyy, qoy, qoo} of K <= 16 Grams (K, n, n) inside
    `dispatch_ok`, with an absolute jitter on the diagonal; only the lower
    triangle is read. CUDA tensors launch `csrc/chol_smallk.cu` (K5: a
    block per Gram up to n = 128, a cluster per Gram beyond); CPU tensors
    take the plain version."""
    if _device_of(grams) == "cpu":
        return chol_quadratics_smallk_plain(grams, y, jitter)
    _check_grams(grams, y)
    kk, n, _ = grams.shape
    grams, y = grams.contiguous(), y.contiguous()
    q = torch.empty((kk, 4), dtype=grams.dtype, device=grams.device)
    ws = _workspace("chol_quadratics_smallk", n, kk, grams)
    fn = _lib_fn("ccgp_chol_quad_smallk", grams.dtype)
    _build.count(chol_quadratics_smallk)
    _build.check(fn(_build.ptr(grams), _build.ptr(y), _build.ptr(q),
                    _build.ptr(ws), n, kk, float(jitter),
                    _build.stream(grams.device)), "chol_quadratics_smallk")
    return _quads(*q.unbind(1))


def fused_mix_quadratics_smallk_plain(x, y, r1, r2, p, jitter=0.0) -> dict:
    """Plain PyTorch version of `fused_mix_quadratics_smallk`."""
    _check_mix(x, y, r1, r2, p)
    return _quads(*_factor_plain(_se_mix_gram_plain(x, r1, r2, p, jitter),
                                 y)[:4])


def fused_mix_quadratics_smallk(x, y, r1, r2, p, jitter=0.0) -> dict:
    """{logdet, qyy, qoy, qoo} of the K SE-mixture correlations
    R_k = (p_k^2 e^{-D1_k} + (1-p_k)^2 e^{-D2_k}) / (p_k^2 + (1-p_k)^2),
    D_i = sum_a r_i[k, a] (x_a - x'_a)^2, built in the kernel from x (n, d),
    r1, r2 (K, d) and p (K,). CUDA tensors launch `csrc/chol_smallk.cu`
    (K6: K5's layout, a block per matrix up to n = 128, a cluster per
    matrix beyond); CPU tensors take the plain version."""
    if _device_of(x) == "cpu":
        return fused_mix_quadratics_smallk_plain(x, y, r1, r2, p, jitter)
    _check_mix(x, y, r1, r2, p)
    n, d = x.shape
    kk = r1.shape[0]
    x, y, r1, r2, p = (t.contiguous() for t in (x, y, r1, r2, p))
    q = torch.empty((kk, 4), dtype=x.dtype, device=x.device)
    ws = _workspace("fused_mix_quadratics_smallk", n, kk, x)
    fn = _lib_fn("ccgp_mix_quad_smallk", x.dtype)
    _build.count(fused_mix_quadratics_smallk)
    _build.check(fn(_build.ptr(x), _build.ptr(y), _build.ptr(r1),
                    _build.ptr(r2), _build.ptr(p), _build.ptr(q),
                    _build.ptr(ws), n, d, kk, float(jitter),
                    _build.stream(x.device)), "fused_mix_quadratics_smallk")
    return _quads(*q.unbind(1))


def _check_round(x, y, r1, r2, p, extra, log_scale, cands, log_u) -> None:
    _check_mix(x, y, r1, r2, p)
    kk = r1.shape[0]
    if cands.ndim != 2 or cands.shape[1] > MAX_D + 2:
        raise ValueError(f"cands must be (K, dim <= {MAX_D + 2})")
    for name, t, shape in (("extra", extra, (kk,)),
                           ("log_scale", log_scale, (kk,)),
                           ("cands", cands, (kk, cands.shape[1])),
                           ("log_u", log_u, (kk,))):
        _same(name, t, x, shape)


def fused_mix_mh_round_plain(x, y, r1, r2, p, extra, log_scale, cands,
                             lp_val, lp_beta, log_u, jitter=0.0):
    """Plain PyTorch version of `fused_mix_mh_round` (same contract)."""
    _check_round(x, y, r1, r2, p, extra, log_scale, cands, log_u)
    n = x.shape[0]
    kk = cands.shape[0]
    ld, qyy, qoy, qoo = _factor_plain(
        _se_mix_gram_plain(x, r1, r2, p, jitter), y)[:4]
    lpv = torch.as_tensor(lp_val, dtype=x.dtype, device=x.device).reshape(())
    lpb = torch.as_tensor(lp_beta, dtype=x.dtype, device=x.device).reshape(())
    beta = qoy / qoo
    quad = qyy - qoy * qoy / qoo
    val = (-0.5 * (n * _LOG2PI + ld + n * log_scale
                   + quad * torch.exp(-log_scale)) + extra)
    acc = (val - lpv) > log_u
    any_acc = acc.any()
    first = torch.argmax(acc.to(torch.int32))
    z_new = torch.where(any_acc, cands[first], torch.zeros_like(cands[0]))
    val_new = torch.where(any_acc, val[first], lpv)
    beta_new = torch.where(any_acc, beta[first], lpb)
    consumed = torch.where(any_acc, first + 1, kk).to(torch.int32)
    return z_new, val_new, beta_new, any_acc, consumed


def fused_mix_mh_round(x, y, r1, r2, p, extra, log_scale, cands, lp_val,
                       lp_beta, log_u, jitter=0.0):
    """ONE speculative Metropolis round: the K6 quadratics of the K
    candidates' SE-mixture Grams, val_k = -0.5 (n log 2pi + logdet_k
    + n log_scale_k + quad_k e^{-log_scale_k}) + extra_k, and the first k
    with (val_k - lp_val) > log_u[k] (a NaN log-posterior rejects).
    Returns (z_new (dim,), val_new, beta_new, any_acc, consumed): with no
    acceptance z_new is 0, val_new = lp_val, beta_new = lp_beta and
    consumed = K. CUDA tensors launch `csrc/chol_smallk.cu` (K7: a cluster
    of min(K, 8) blocks up to n = 128, one block beyond); CPU tensors take
    the plain version."""
    if _device_of(x) == "cpu":
        return fused_mix_mh_round_plain(x, y, r1, r2, p, extra, log_scale,
                                        cands, lp_val, lp_beta, log_u,
                                        jitter)
    _check_round(x, y, r1, r2, p, extra, log_scale, cands, log_u)
    n, d = x.shape
    kk, dim = cands.shape
    dt, dev = x.dtype, x.device
    st = torch.stack([torch.as_tensor(v, dtype=dt, device=dev).reshape(())
                      for v in (lp_val, lp_beta)])
    # every buffer stays referenced here until the launch is queued
    bufs = [t.contiguous() for t in (x, y, r1, r2, p, extra, log_scale,
                                     cands)]
    bufs += [st, log_u.contiguous()]
    z_out = torch.empty(dim, dtype=dt, device=dev)
    vb = torch.empty(2, dtype=dt, device=dev)
    info = torch.empty(2, dtype=torch.int32, device=dev)
    ws = _workspace("fused_mix_mh_round", n, kk, x)
    fn = _lib_fn("ccgp_mix_mh_round", dt)
    _build.count(fused_mix_mh_round)
    _build.check(fn(*(_build.ptr(t) for t in bufs), _build.ptr(z_out),
                    _build.ptr(vb), _build.ptr(info), _build.ptr(ws), n, d,
                    dim, kk, float(jitter), _build.stream(dev)),
                 "fused_mix_mh_round")
    return z_out, vb[0], vb[1], info[0] > 0, info[1]


chol_quadratics_smallk.launches = 0
fused_mix_quadratics_smallk.launches = 0
fused_mix_mh_round.launches = 0
