"""Smoke run of the PyTorch/CUDA port (`ccgp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA device must be present (there is no CPU path); print
     its name and `nvidia-smi`'s name and power limit;
  2. build the CUDA kernels from `ccgp_tpu_torch/csrc` (one nvcc per
     source, in parallel; sm_90a);
  3. the threefry key-chain kernel against its plain PyTorch version:
     integer equality;
  4. the fused Metropolis-rounds kernel against its plain version on the
     same inputs: equal acceptance flags and consumed counts, records
     and decoded stash within the stated tolerances (bench shape in f32
     and f64, a multi-tile n in f32, a small n in f64);
  7. the batched Cholesky kernels (quadratics K3, factors K4) against
     their plain versions: B in {128, 64, 200, 1728} x n in {100, 14,
     128}, f32 and f64, plus an indefinite and a rank-deficient batch
     whose NaNs must fall on the same matrices, and a batch with NaN
     above the diagonal (only the lower triangle may be read);
  5. the full-Bayes path: `fit_combined_gp` -> `predict_combined_gp` at the
     bench workload (2-D anisotropic SE x SE, tied rough rates, n = 100,
     25 x 25 lattice, speculative K = 4, n_max 5000, samp_size 1000, f32,
     jitter 1e-3, PRNGKey(7)), accuracy- and chain-guarded; then the same
     slice at a small f64 size on the GPU against the CPU (plain twins);
  8. the MAP path (`bench.py:92-174` composed from the port: a 24-point
     plug-in grid, a 128-point Halton cloud and a 64-point zoom through
     `chol_quadratics`, predict at the MAP) at the bench size, f32,
     rmspe-guarded;
  9. the empirical-Bayes hyperprior scan: 60 rows x 1728 Halton nodes,
     tau = 100, n = 14, f64, on the GPU and on the CPU (plain twins):
     the same row, log-likelihoods within 1e-9;
 10. the draw-chunked predict: `fit_combined_gp(draw_chunk=64)` ->
     `predict_combined_gp` with phase 5's key: the same chain, and
     predictions that match phase 5's stash path;
  6. each kernel's time next to its plain version's and a library call's
     at the main paths' shapes: device time under torch.profiler where
     it kept a record of every launch the wrapper counted, else the
     CUDA-event time per call.

Every path (5, 8, 9, 10) runs with all launch counters set to 0 just
before it and read just after; each must launch its kernels. The last
lines are a JSON object of kernel records, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

F32_RTOL = 1e-4     # f32 kernel vs plain: records and decoded stash
F64_RTOL = 1e-10    # f64 kernel vs plain
# Peak rates of one H100 SXM (NVIDIA's data sheet and Hopper white paper):
# memory 3.35 TB/s; f32 67 TFLOP/s and f64 34 TFLOP/s outside the tensor
# cores; int32 16.7 TOP/s (64 INT32 lanes per SM x 132 SMs x 1.98 GHz).
HBM_BPS = 3.35e12
PEAK_OPS = {4: 67e12, 8: 34e12, "int32": 16.7e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on the GPU only")
    # full-precision float32 products for distances and Grams (TF32 keeps
    # ~3 digits and breaks the Cholesky factorizations)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from ccgp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[2] built {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_rng():
    from ccgp_tpu_torch.ops import rng

    err = 0
    for seed in (0, 7, 123456789):
        for rr in (1, 7, 20, 24, 25, 120):
            key = rng.PRNGKey(seed, device="cuda")
            got = rng.threefry_split_chain(key, rr)
            ref = rng.threefry_split_chain_plain(key, rr)
            for g, r in zip(got, ref):
                err = max(err, int(torch.max(torch.abs(g - r))))
            if err:
                raise AssertionError(
                    f"threefry_split_chain differs at seed={seed} rr={rr}")
    log("[3] threefry_split_chain == plain (integers) for rr in "
        "{1,7,20,24,25,120} x seeds {0,7,123456789}")
    return float(err)


def f2(xy):
    a, b = xy[:, 0], xy[:, 1]
    return (((a - 0.2) ** 2 - (b - 0.7) ** 2)
            * np.exp(-5 * ((a - 0.8) ** 2 + (b - 0.1) ** 2))
            * np.cos(10 * (a - 0.5) * b))


def bench_data(n: int = 100):
    x = np.random.default_rng(0).uniform(size=(n, 2))
    u = np.linspace(0, 1, 25)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    return x, f2(x), grid


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(1, max |b|) over finite entries."""
    a, b = a.double().cpu(), b.double().cpu()
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return math.inf
    m = torch.isfinite(b)
    if not bool(m.any()):
        return 0.0
    return float(torch.max(torch.abs(a[m] - b[m]))
                 / max(1.0, float(torch.max(torch.abs(b[m])))))


def _rounds_case(n, rr, dtype, jitter, seed):
    from ccgp_tpu_torch.models.likelihood import cand_model_for
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import kernels

    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    kk, dim = 4, 4
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device="cuda")  # noqa: E731
    model = cand_model_for(spec, t(x), LogNormal(-1.0, 1.0),
                           InverseGamma(3, 4))
    args = dict(x=t(x), y=t(f2(x)), z=t([0.6, 0.4, 0.1, -0.2]),
                lp_val=t(-1e6), lp_beta=t(0.0), sigma2=t(0.05),
                deltas=t(0.25 * r.normal(size=(rr * kk, dim))),
                log_u=t(np.log(r.uniform(size=(rr, kk)))), model=model,
                jitter=jitter, stash=True)
    return args


def _compare_rounds(args, rtol, label):
    from ccgp_tpu_torch.ops import chol_smallk
    from ccgp_tpu_torch.predict.factors import decode_stash

    got = chol_smallk.fused_mix_mh_rounds(**args)
    ref = chol_smallk.fused_mix_mh_rounds_plain(**args)
    torch.cuda.synchronize()
    if not torch.equal(got["acc"], ref["acc"]):
        raise AssertionError(f"{label}: acc differs")
    if not torch.equal(got["consumed"], ref["consumed"]):
        raise AssertionError(f"{label}: consumed differs")
    n = args["x"].shape[0]
    acc = ref["acc"]
    if int(acc.sum()) < 1:
        raise AssertionError(f"{label}: no round accepted")
    err_rec = _rel_err(got["rec"], ref["rec"])
    dg = decode_stash(got["stash"][acc], n)
    dr = decode_stash(ref["stash"][acc], n)
    err_stash = max(_rel_err(a, b) for a, b in zip(dg, dr))
    abs_err = max(float(torch.max(torch.abs(got["rec"] - ref["rec"]))),
                  *(float(torch.max(torch.abs(a - b)))
                    for a, b in zip(dg, dr)))
    if not (err_rec <= rtol and err_stash <= rtol):
        raise AssertionError(f"{label}: rec err {err_rec:.3g}, stash err "
                             f"{err_stash:.3g} > {rtol:g}")
    log(f"[4] {label}: acc/consumed equal ({int(acc.sum())}/"
        f"{acc.numel()} accepted), rec rel err {err_rec:.3g}, stash rel "
        f"err {err_stash:.3g} (tol {rtol:g})")
    return abs_err


def phase_rounds():
    errs = []
    for rr in (20, 120):
        errs.append(_compare_rounds(
            _rounds_case(100, rr, torch.float32, 1e-3, seed=rr),
            F32_RTOL, f"bench shape n=100 K=4 R={rr} f32"))
    errs.append(_compare_rounds(
        _rounds_case(300, 4, torch.float32, 1e-3, seed=3), F32_RTOL,
        "multi-tile n=300 K=4 R=4 f32"))
    _compare_rounds(_rounds_case(16, 6, torch.float64, 1e-9, seed=2),
                    F64_RTOL, "small n=16 K=4 R=6 f64")
    _compare_rounds(_rounds_case(100, 20, torch.float64, 1e-6, seed=4),
                    F64_RTOL, "bench n=100 K=4 R=20 f64")
    return max(errs)


def _spec():
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.ops import kernels

    return MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)


def _fit_predict(x, y, grid, seed, dtype, device, jitter, draw_chunk=None,
                 **cfg):
    from ccgp_tpu_torch.models.combined_gp import (
        MCMCConfig, fit_combined_gp, predict_combined_gp)
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import rng

    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    kf, kp = rng.split(rng.PRNGKey(seed, device=device), 2)
    spec = _spec()
    fit = fit_combined_gp(spec, t(x), t(y), kf,
                          mcmc=MCMCConfig(start=(1.0, 1.0, 0.0, 0.0),
                                          speculative=4, **cfg),
                          theta1_prior=LogNormal(-1.0, 1.0),
                          theta2_prior=InverseGamma(3, 4),
                          jitter=jitter, mle_method="grid",
                          draw_chunk=draw_chunk, device=device)
    pred = predict_combined_gp(spec, fit, t(x), t(grid), kp,
                               draw_chunk=draw_chunk or 64, device=device)
    return fit, pred


def _counted():
    """Every kernel wrapper, by the name its launch counter reports."""
    from ccgp_tpu_torch.ops import chol_lanes, chol_smallk, rng

    return {"threefry_split_chain": rng.threefry_split_chain,
            "fused_mix_mh_rounds": chol_smallk.fused_mix_mh_rounds,
            "chol_quadratics_lanes": chol_lanes.chol_quadratics_lanes,
            "chol_factors_lanes": chol_lanes.chol_factors_lanes}


def _zero_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in _counted().items()}


def _require_launched(counts: dict, names, path: str) -> None:
    for k in names:
        if counts[k] < 1:
            raise AssertionError(f"{k} was not launched on the {path}")


BENCH_CFG = dict(n_max=5000, samp_size=1000, net_samp_size=1000)


def phase_main_path():
    x, y, grid = bench_data()
    _zero_counts()
    fit, pred = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                             **BENCH_CFG)
    launches = _read_counts()
    mc = fit.mcmc
    mean = pred.mean.double().cpu().numpy()
    lo, hi = pred.lower.double().cpu().numpy(), pred.upper.double().cpu().numpy()
    if mean.shape != (625,) or not np.isfinite(mean).all():
        raise AssertionError("non-finite or misshapen predictions")
    y_true = f2(grid)
    rmspe = float(np.sqrt(np.mean((y_true - mean) ** 2)))
    cover = float(np.mean((y_true >= lo) & (y_true <= hi)))
    log(f"[5] main path: n_recorded={mc.n_recorded} n_proposals="
        f"{mc.n_proposals} n_rounds={mc.n_rounds} chain_ok={fit.chain_ok} "
        f"sigma2={float(fit.sigma2):.6g} rmspe={rmspe:.5f} "
        f"coverage95={cover:.3f} launches={launches}")
    if not rmspe < 0.03:
        raise AssertionError(f"bayes accuracy regression: rmspe={rmspe}")
    if not cover >= 0.80:
        raise AssertionError(f"bayes calibration regression: {cover}")
    if not fit.chain_ok:
        raise AssertionError(f"chain unhealthy: n_recorded={mc.n_recorded}")
    _require_launched(launches, ("threefry_split_chain",
                                 "fused_mix_mh_rounds"), "full-Bayes path")

    # timed run (same key, so the same chain), CUDA events
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    fit2, pred2 = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                               **BENCH_CFG)
    ev1.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms = ev0.elapsed_time(ev1)
    if fit2.mcmc.n_recorded != mc.n_recorded:
        raise AssertionError("the timed run took another chain")
    log(f"[5] full-Bayes fit+predict: {ms:.1f} ms (CUDA events), wall "
        f"{wall_ms:.1f} ms, {1e3 * ms / mc.n_rounds:.1f} us/round over "
        f"{mc.n_rounds} rounds")
    _log_profile("[5] full-Bayes", ms, lambda: _fit_predict(
        x, y, grid, 7, torch.float32, "cuda", 1e-3, **BENCH_CFG), 1,
        warm=False)

    # small f64 slice: GPU (kernels) against CPU (plain twins)
    xs = np.random.default_rng(0).uniform(size=(20, 2))
    ys = np.sin(5 * xs[:, 0]) + np.cos(3 * xs[:, 1])
    u = np.linspace(0, 1, 6)
    gs = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    small = dict(n_max=400, samp_size=120, net_samp_size=120)
    fg, pg = _fit_predict(xs, ys, gs, 1, torch.float64, "cuda", 1e-6, **small)
    fc, pc = _fit_predict(xs, ys, gs, 1, torch.float64, "cpu", 1e-6, **small)
    for a in ("n_recorded", "n_proposals", "n_rounds", "converged"):
        if getattr(fg.mcmc, a) != getattr(fc.mcmc, a):
            raise AssertionError(f"small slice: {a} differs GPU vs CPU")
    err = max(_rel_err(getattr(pg, a), getattr(pc, a))
              for a in ("mean", "lower", "upper"))
    if not err <= 1e-6:
        raise AssertionError(f"small slice: GPU vs CPU rel err {err:.3g}")
    log(f"[5] small f64 slice GPU == CPU: n_recorded={fg.mcmc.n_recorded} "
        f"n_rounds={fg.mcmc.n_rounds}, mean/lower/upper rel err {err:.3g}")
    return launches, fit, pred


# ---------------------------------------------------------------------------
# the batched Cholesky kernels (K3 quadratics, K4 factors)
# ---------------------------------------------------------------------------

def se_grams(b, n, seed):
    """(B, n, n) SE Grams on one uniform design with rates spread over the
    batch (rough to smooth), and a response (n,): numpy float64."""
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    theta = np.exp(np.linspace(0.0, 3.0, b))
    return np.exp(-theta[:, None, None] * d2[None]), r.normal(size=n)


def _compare_lanes(g, y, jitter, label, expect_nan=None):
    """Both kernels against their plain versions on the card. Returns the
    largest relative error, the largest absolute difference over finite
    entries, and the number of matrices whose logdet is NaN."""
    from ccgp_tpu_torch.ops import chol_lanes

    tol = F32_RTOL if g.dtype == torch.float32 else F64_RTOL
    err, abs_err = 0.0, 0.0
    for kern, plain in ((chol_lanes.chol_quadratics_lanes,
                         chol_lanes.chol_quadratics_lanes_plain),
                        (chol_lanes.chol_factors_lanes,
                         chol_lanes.chol_factors_lanes_plain)):
        got = kern(g, y, jitter=jitter)
        ref = plain(g, y, jitter=jitter)
        torch.cuda.synchronize()
        if set(got) != set(ref):
            raise AssertionError(f"{label}: {kern.__name__} keys differ")
        for k in ref:
            e = _rel_err(got[k], ref[k])
            if not e <= tol:
                raise AssertionError(f"{label}: {kern.__name__}[{k}] rel err "
                                     f"{e:.3g} > {tol:g} (or NaNs differ)")
            fin = torch.isfinite(ref[k])
            if bool(fin.any()):
                abs_err = max(abs_err, float(torch.max(torch.abs(
                    got[k][fin] - ref[k][fin]))))
            err = max(err, e)
        nan = ~torch.isfinite(got["logdet"])
        if expect_nan is not None and not torch.equal(nan.cpu(), expect_nan):
            raise AssertionError(f"{label}: NaN on the wrong matrices")
    return err, abs_err, int(nan.sum())


def phase_lanes():
    from ccgp_tpu_torch.ops import chol_lanes

    abs_errs = []
    for dtype, jitter in ((torch.float32, 1e-3), (torch.float64, 1e-6)):
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        errs = []
        for b in (128, 64, 200, 1728):
            for n in (100, 14, 128):
                g, y = se_grams(b, n, seed=b + n)
                err, ae, _ = _compare_lanes(t(g), t(y), jitter,
                                            f"B={b} n={n} {dtype}")
                errs.append(err)
                abs_errs.append(ae)
        log(f"[7] chol lanes kernels == plain for B in {{128,64,200,1728}} "
            f"x n in {{100,14,128}} {dtype}: max rel err {max(errs):.3g}")
        # only the lower triangle is read: NaN above the diagonal changes
        # no output
        g, y = (t(a) for a in se_grams(128, 100, seed=5))
        junk = g.clone()
        iu = torch.triu_indices(100, 100, 1, device="cuda")
        junk[:, iu[0], iu[1]] = math.nan
        for kern in (chol_lanes.chol_quadratics_lanes,
                     chol_lanes.chol_factors_lanes):
            ref, got = kern(g, y, jitter=jitter), kern(junk, y, jitter=jitter)
            if not all(torch.equal(got[k], ref[k]) for k in ref):
                raise AssertionError(f"{kern.__name__} {dtype}: the upper "
                                     f"triangle changed an output")
        log(f"[7] {dtype}: NaN above the diagonal changes no output of "
            f"either kernel (B=128 n=100)")
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        # odd members: rank n/2 minus 1e-2 I (a negative pivot, NaN);
        # even members plus 1e-2 I (finite)
        r = np.random.default_rng(3)
        v = r.normal(size=(128, 100, 50))
        low = v @ np.swapaxes(v, 1, 2) / 100
        shift = np.where(np.arange(128) % 2 == 1, -1e-2, 1e-2)
        g = low + shift[:, None, None] * np.eye(100)
        y = r.normal(size=100)
        _, ae, nan = _compare_lanes(t(g), t(y), 0.0, f"indefinite {dtype}",
                                    expect_nan=torch.arange(128) % 2 == 1)
        abs_errs.append(ae)
        # exactly rank-deficient, no jitter: NaN wherever roundoff turns a
        # zero pivot negative, on the same matrices in kernel and twin
        _, ae, nan_rd = _compare_lanes(t(low), t(y), 0.0,
                                       f"rank-deficient {dtype}")
        abs_errs.append(ae)
        log(f"[7] {dtype}: indefinite batch NaN on the {nan} odd members; "
            f"rank-deficient batch (jitter 0) NaN on {nan_rd} of 128, the "
            f"same in kernel and twin")
    return max(abs_errs)


# ---------------------------------------------------------------------------
# the MAP path (the JAX package's bench.py:92-174, composed from the port)
# ---------------------------------------------------------------------------

MAP_BOX = (np.array([6.0, 6.0, 8.0, 5.0]), np.array([-2.0, -2.0, -4.0, -3.0]))


def map_fit_predict(x, y, grid, n_cloud=128, n_zoom=64, jitter=1e-3):
    """The MAP program: sigma^2 from a 24-point log-theta grid plus one
    parabolic refinement, the 4-parameter MAP by a Halton cloud and one
    zoomed re-scan (each one batched `chol_quadratics` call: B >= 64 goes
    to the lanes kernel), then predict at the MAP over `grid`. Returns
    {mean, var, z_map, sigma2}. Runs on x's device and dtype."""
    from ccgp_tpu_torch.eb import halton
    from ccgp_tpu_torch.models.combination import (
        mixed_cross, mixed_gram, unpack)
    from ccgp_tpu_torch.models.likelihood import make_logpost
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import kernels, linalg
    from ccgp_tpu_torch.ops.chol import (
        chol_quadratics, mvn_nll_from_quadratics, profile_nll_from_quadratics)
    from ccgp_tpu_torch.ops.gp import gls_beta, sigma2_mle

    dt, dev = x.dtype, x.device
    n = x.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    inf = t(math.inf)
    fam, spec = kernels.sqexp_family(), _spec()

    # 1) plug-in sigma^2 (a batch of 24: the plain path)
    mg = t(np.linspace(-5.0, 6.0, 24))
    q0 = chol_quadratics(fam.gram(x, torch.exp(mg)[:, None]), y, jitter=jitter)
    nlls = profile_nll_from_quadratics(q0, n)
    nlls = torch.where(torch.isfinite(nlls), nlls, inf)
    im = min(max(int(torch.argmin(nlls)), 1), mg.shape[0] - 2)
    f0, f1, f2_ = nlls[im - 1], nlls[im], nlls[im + 1]
    h = mg[1] - mg[0]
    denom = f0 - 2.0 * f1 + f2_
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * h * (f0 - f2_) / denom,
                        torch.zeros_like(denom))
    lt_opt = mg[im] + torch.clamp(shift, -h, h)
    chol0 = linalg.jitter_cholesky(fam.gram(x, torch.exp(lt_opt)), jitter)
    sigma2 = sigma2_mle(chol0, y, gls_beta(chol0, y))

    # 2) the MAP: a Halton cloud, then one zoom around the incumbent
    ln_prior, ig_prior = LogNormal(-1.0, 1.0), InverseGamma(3, 4)

    def neg_logpost(zs):
        params, log_jac = unpack(spec, zs)
        q = chol_quadratics(mixed_gram(spec, x, params), y, jitter=jitter)
        s2mix = params.p ** 2 + (1.0 - params.p) ** 2
        core = mvn_nll_from_quadratics(q, n, torch.log(s2mix * sigma2))
        lp = (-0.5 * (core + n * math.log(2.0 * math.pi)) + log_jac
              + torch.sum(ln_prior.log_kernel(params.theta1), dim=-1)
              + ig_prior.log_kernel(params.theta2))
        return torch.where(torch.isfinite(lp), -lp, inf)

    cloud = t(halton(n_cloud, 4) * MAP_BOX[0] + MAP_BOX[1])
    vals = neg_logpost(cloud)
    best = int(torch.argmin(vals))
    z_best, v_best = cloud[best], vals[best]
    cand = z_best[None, :] + 1.2 * t(halton(n_zoom, 4, start=17) - 0.5)
    vals = neg_logpost(cand)
    best = int(torch.argmin(vals))
    if bool(vals[best] < v_best):
        z_best = cand[best]

    # 3) predict at the MAP
    out = make_logpost(spec, x, y, sigma2, theta1_prior=ln_prior,
                       theta2_prior=ig_prior, jitter=jitter)(z_best)
    params, _ = unpack(spec, z_best)
    v = linalg.tri_solve(out.chol, mixed_cross(spec, x, grid, params))
    a = linalg.tri_solve(out.chol, y - out.beta)
    u = linalg.tri_solve(out.chol, torch.ones_like(y))
    mean = out.beta + a @ v
    var = sigma2 * (1.0 - torch.sum(v * v, dim=0)
                    + (1.0 - u @ v) ** 2 / torch.sum(u * u))
    return {"mean": mean, "var": var, "z_map": z_best, "sigma2": sigma2}


def phase_map():
    x, y, grid = bench_data()
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    _zero_counts()
    out = map_fit_predict(t(x), t(y), t(grid))
    launches = _read_counts()
    mean = out["mean"].double().cpu().numpy()
    if mean.shape != (625,) or not np.isfinite(mean).all():
        raise AssertionError("MAP path: non-finite or misshapen predictions")
    rmspe = float(np.sqrt(np.mean((f2(grid) - mean) ** 2)))
    z = [round(float(v), 5) for v in out["z_map"]]
    log(f"[8] MAP path: z_map={z} sigma2={float(out['sigma2']):.6g} "
        f"rmspe={rmspe:.5f} launches={launches}")
    if not rmspe < 0.02:
        raise AssertionError(f"MAP accuracy regression: rmspe={rmspe}")
    if launches["chol_quadratics_lanes"] < 2:
        raise AssertionError("the MAP scans did not go through the kernel")
    ms = _cuda_ms(lambda: map_fit_predict(t(x), t(y), t(grid)), 5)
    log(f"[8] MAP fit+predict: {ms:.2f} ms (CUDA events, mean of 5)")
    _log_profile("[8] MAP", ms, lambda: map_fit_predict(t(x), t(y), t(grid)),
                 3)
    return launches, ms, rmspe


# ---------------------------------------------------------------------------
# the empirical-Bayes hyperprior scan
# ---------------------------------------------------------------------------

def eb_grid() -> np.ndarray:
    """A stand-in 60-row (a1, b1, a2, b2) inverse-gamma grid, the
    reference's grid size: a1 in {3, 5}, b1 in {4, 8, 16}, a2 in {3, 5},
    b2 in {16, 32, 64, 128, 256}."""
    return np.array([(a1, b1, a2, b2) for a1 in (3.0, 5.0)
                     for b1 in (4.0, 8.0, 16.0) for a2 in (3.0, 5.0)
                     for b2 in (16.0, 32.0, 64.0, 128.0, 256.0)])


def phase_eb():
    from ccgp_tpu_torch.eb import choose_hyperpars
    from ccgp_tpu_torch.infer.mle import kriging_mle_grid
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.ops import kernels

    x = np.random.default_rng(0).uniform(size=(14, 2))
    y = f2(x)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    grid = eb_grid()
    t = lambda a: torch.tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    s2 = float(kriging_mle_grid(kernels.sqexp_family(), t(x), t(y)).sigma2)
    _zero_counts()
    t0 = time.perf_counter()
    g = choose_hyperpars(spec, x, y, grid, s2, n_nodes=1728, tau=100.0,
                         device="cuda")
    launches = _read_counts()
    first_ms = (time.perf_counter() - t0) * 1e3
    scan = lambda: choose_hyperpars(  # noqa: E731
        spec, x, y, grid, s2, n_nodes=1728, tau=100.0, device="cuda")
    t0 = time.perf_counter()
    scan()
    torch.cuda.synchronize()
    gpu_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    c = choose_hyperpars(spec, x, y, grid, s2, n_nodes=1728, tau=100.0,
                         device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = _rel_err(g.likelihoods, c.likelihoods)
    log(f"[9] EB scan 60 x 1728, n=14, f64: row {int(g.index)} "
        f"{g.pars.tolist()} on the GPU, row {int(c.index)} on the CPU; "
        f"log-likelihoods rel err {err:.3g}; GPU {gpu_ms:.1f} ms (first "
        f"call {first_ms:.1f} ms), CPU {cpu_ms:.1f} ms (host clock); "
        f"launches={launches}")
    _log_profile("[9] EB", gpu_ms, scan, 1, warm=False)
    if launches["chol_quadratics_lanes"] != 60:
        raise AssertionError("each EB row must be one kernel launch")
    if int(g.index) != int(c.index):
        raise AssertionError("the EB scan chose another row on the GPU")
    if not bool(torch.isfinite(g.likelihoods).all()):
        raise AssertionError("non-finite EB log-likelihoods")
    if not err <= 1e-9:
        raise AssertionError(f"EB log-likelihoods GPU vs CPU {err:.3g}")
    return launches, gpu_ms, cpu_ms


# ---------------------------------------------------------------------------
# the draw-chunked predict
# ---------------------------------------------------------------------------

LAZY_RTOL = F32_RTOL   # see phase_lazy


def phase_lazy(fit, pred):
    """fit_combined_gp(draw_chunk=64) with phase 5's key. The chain is the
    same (the sampler stashes either way); the factors are rebuilt by the
    lanes factor kernel, 64 draws per launch, from Grams built by
    `mixed_gram`, while the stash path's came from the rounds kernel's own
    Gram and pivot order (rsqrt-scaled rows). The two f32 factorizations
    round differently, and the sums of the moments run in another order,
    so the predictions agree to f32 roundoff amplified by the Grams'
    conditioning (jitter 1e-3), not to the last place: LAZY_RTOL, the
    f32 tolerance, relative to max(1, |value|)."""
    from ccgp_tpu_torch.models.combined_gp import predict_combined_gp
    from ccgp_tpu_torch.ops import rng

    x, y, grid = bench_data()
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    _zero_counts()
    fl, pl = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                          draw_chunk=64, **BENCH_CFG)
    launches = _read_counts()
    if fl.cache.chol.shape[0] != 0:
        raise AssertionError("draw_chunk did not give a lazy cache")
    for a in ("n_recorded", "n_proposals", "n_rounds"):
        if getattr(fl.mcmc, a) != getattr(fit.mcmc, a):
            raise AssertionError(f"lazy fit: {a} differs from the stash run")
    if not torch.equal(fl.zs, fit.zs):
        raise AssertionError("lazy fit: the retained draws differ")
    errs = {a: _rel_err(getattr(pl, a), getattr(pred, a))
            for a in ("mean", "lower", "upper")}
    log(f"[10] draw-chunked predict: same chain ({fl.mcmc.n_recorded} "
        f"recorded), vs the stash path rel err {errs} (tol {LAZY_RTOL:g}); "
        f"launches={launches}")
    if launches["chol_factors_lanes"] != 16:
        raise AssertionError("1000 draws in chunks of 64 must be 16 launches")
    _require_launched(launches, ("chol_factors_lanes", "fused_mix_mh_rounds",
                                 "threefry_split_chain"), "lazy path")
    if not max(errs.values()) <= LAZY_RTOL:
        raise AssertionError(f"lazy predict vs stash path: {errs}")
    predict = lambda: predict_combined_gp(  # noqa: E731
        _spec(), fl, t(x), t(grid), rng.PRNGKey(1, device="cuda"),
        draw_chunk=64)
    ms = _cuda_ms(predict, 3)
    log(f"[10] draw-chunked predict alone: {ms:.2f} ms (CUDA events, mean "
        f"of 3)")
    _log_profile("[10] lazy predict", ms, predict, 3)
    return launches


# each counted wrapper's kernel, by substrings of the demangled name the
# profiler gives it
_SYMBOLS = {"threefry_split_chain": ("split_chain_kernel",),
            "fused_mix_mh_rounds": ("mh_rounds_kernel<",),
            "chol_quadratics_lanes": ("chol_lanes_kernel<", ", false>"),
            "chol_factors_lanes": ("chol_lanes_kernel<", ", true>")}


def _device_profile(fn, reps, warm=True):
    """`reps` calls of fn under torch.profiler. Returns ({kernel name:
    (ms per call, records)}, {counted wrapper: launches in those calls});
    the first is empty when no device activity was seen. A name's time
    is its records' sum over `reps`: nothing is extrapolated. The
    profiler can lose records (1-3 of a timing loop's launches went
    missing), so the window is padded at both ends with spin kernels,
    which are left out of the result; `_lost` says where records were
    lost all the same. One stream: nothing overlaps."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        torch.cuda.synchronize()
        for _ in range(4):
            torch.cuda._sleep(20000)
        torch.cuda.synchronize()

    if warm:
        fn()
        torch.cuda.synchronize()
    before = {k: f.launches for k, f in _counted().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad()
        for _ in range(reps):
            fn()
        pad()
    launched = {k: f.launches - before[k] for k, f in _counted().items()}
    records = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.name):
            records.setdefault(e.name, []).append(e.time_range.elapsed_us())
    by_name = {name: (sum(d) / reps / 1e3, len(d))
               for name, d in records.items()}
    return by_name, launched


def _is_kernel(wrapper: str, name: str) -> bool:
    return all(s in name for s in _SYMBOLS[wrapper])


def _of_kernel(wrapper: str, by_name) -> tuple:
    """(ms per call, records) of a counted wrapper's kernel."""
    hits = [v for name, v in by_name.items() if _is_kernel(wrapper, name)]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def _lost(by_name, launched, reps) -> list:
    """Where the profiler kept fewer records than there were launches:
    each counted kernel with fewer records than its wrapper's launch
    count, and each other kernel whose records are not a whole multiple
    of `reps` (the calls are alike, so each launches it equally often)."""
    out = [f"{k}: {_of_kernel(k, by_name)[1]} of {n} records"
           for k, n in launched.items() if _of_kernel(k, by_name)[1] < n]
    out += [f"{name[:50]}: {r} records over {reps} calls"
            for name, (_, r) in by_name.items()
            if r % reps and not any(_is_kernel(k, name) for k in _SYMBOLS)]
    return out


def _kernel_ms(wrapper: str, fn, reps, call_ms):
    """(ms, how) for one call of a counted wrapper that launches its
    kernel once: the kernel's profiler records over `reps` calls when
    there are as many as the wrapper counted launches; else, after one
    retry, the CUDA-event time per call `call_ms` (host launch included),
    and the shortfall is logged."""
    for _ in range(2):
        by_name, launched = _device_profile(fn, reps)
        ms, seen = _of_kernel(wrapper, by_name)
        if launched[wrapper] == reps and seen == reps:
            return ms, "on the device"
        log(f"[6] {wrapper}: the profiler kept {seen} records of "
            f"{launched[wrapper]} launches")
    return call_ms, "per call (CUDA events; profiler records lost)"


def _library_ms(fn, reps, call_ms):
    """(ms, how) for a library route: its device time per call under the
    profiler when no record was lost (`_lost`); else the CUDA-event time
    per call `call_ms`."""
    by_name, launched = _device_profile(fn, reps)
    lost = _lost(by_name, launched, reps)
    if by_name and not lost:
        return sum(v[0] for v in by_name.values()), "on the device"
    log(f"[6] library route: profiler records lost ({'; '.join(lost)})")
    return call_ms, "per call (CUDA events; profiler records lost)"


def _log_profile(tag: str, wall_ms: float, fn, reps, warm=True) -> None:
    """Log a path's device-busy time against its wall time and its five
    largest kernels by device time, and any records the profiler lost
    (then the busy time is a lower bound)."""
    by_name, launched = _device_profile(fn, reps, warm)
    if not by_name:
        log(f"{tag} device time not measured (no device activity seen)")
        return
    dev = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    kernels = "; ".join(f"{name[:60]} {ms:.3f} ms" for name, (ms, _) in top)
    lost = _lost(by_name, launched, reps)
    log(f"{tag} device busy {dev:.3f} ms per call of {wall_ms:.1f} ms "
        f"({100 * dev / wall_ms:.1f}%), {len(by_name)} kernel names; "
        f"largest: {kernels}; "
        + (f"records lost, busy is a lower bound: {'; '.join(lost)}"
           if lost else "no record lost"))


def _cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _lanes_bound(b, n, elem, factors):
    """(ms, what bounds it) for B Cholesky factorizations with two
    forward solves: each Gram's lower triangle (n (n + 1) / 2 entries,
    all a factorization needs) and y read once, each output written once
    (K4's factor is dense, n x n); n^3/3 + 2 n^2 + 6 n operations per
    matrix."""
    nbytes = elem * (b * n * (n + 1) // 2 + n + 4 * b
                     + (b * n * n + 2 * b * n if factors else 0))
    ops = b * (n ** 3 / 3 + 2 * n * n + 6 * n)
    return _bound(nbytes, ops, PEAK_OPS[elem])


def _bound(nbytes, ops, peak):
    tb, to = nbytes / HBM_BPS, ops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _library_lanes(g, y, jitter):
    """One PyTorch route to the same results: cholesky_ex, then one
    triangular solve of [y, 1] (timed only; the port never calls it)."""
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    chol, _ = torch.linalg.cholesky_ex(g + jitter * eye)
    rhs = torch.stack([y, torch.ones_like(y)], -1).expand(g.shape[0], -1, -1)
    return chol, torch.linalg.solve_triangular(chol, rhs, upper=False)


def _lanes_inputs(fit):
    """The lanes kernels' inputs at the main paths' shapes: the MAP cloud's
    and zoom's Grams (B = 128 and 64, n = 100, f32), one EB row's
    covariances (B = 1728, n = 14, f64) and the lazy predict's first chunk
    (B = 64 draws of the bench chain, n = 100, f32)."""
    from ccgp_tpu_torch.eb import halton
    from ccgp_tpu_torch.models.combination import (
        MixParams, MixtureSpec, mixed_gram, unpack)
    from ccgp_tpu_torch.ops import kernels
    from ccgp_tpu_torch.ops.special import invgamma_quantile

    x, y, _ = bench_data()
    t32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    spec = _spec()
    cloud = t32(halton(128, 4) * MAP_BOX[0] + MAP_BOX[1])
    zoom = 1.2 * t32(halton(64, 4, start=17) - 0.5)
    grams = {"map_cloud": mixed_gram(spec, t32(x), unpack(spec, cloud)[0]),
             "map_zoom": mixed_gram(spec, t32(x), unpack(spec, zoom)[0]),
             "lazy_chunk": mixed_gram(spec, t32(x),
                                      unpack(spec, fit.zs[:64])[0])}
    xe = np.random.default_rng(0).uniform(size=(14, 2))
    p = torch.tensor(halton(1728, 1)[:, 0], dtype=torch.float64, device="cuda")
    params = MixParams(p=p, theta1=invgamma_quantile(p, 3.0, 2.0),
                       theta2=invgamma_quantile(p, 5.0, 16.0))
    iso = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    xe_t = torch.tensor(xe, dtype=torch.float64, device="cuda")
    s2t = 0.01 * (p * p + (1.0 - p) ** 2)
    grams["eb_row"] = s2t[:, None, None] * mixed_gram(iso, xe_t, params) + 1e4
    ys = {"map_cloud": t32(y), "map_zoom": t32(y), "lazy_chunk": t32(y),
          "eb_row": torch.tensor(f2(xe), dtype=torch.float64, device="cuda")}
    jit = {"map_cloud": 1e-3, "map_zoom": 1e-3, "lazy_chunk": 1e-3,
           "eb_row": 0.0}
    return grams, ys, jit


def phase_timing(fit):
    from ccgp_tpu_torch.models.combination import mixed_gram, unpack
    from ccgp_tpu_torch.ops import chol_lanes, chol_smallk, rng

    key = rng.PRNGKey(7, device="cuda")
    out = {}
    for rr in (120, 20):
        fn = lambda: rng.threefry_split_chain(key, rr)  # noqa: E731
        call = _cuda_ms(fn, 50)
        k, how = _kernel_ms("threefry_split_chain", fn, 50, call)
        p = _cuda_ms(lambda: rng.threefry_split_chain_plain(key, rr), 3)
        # key in, new key and 2 rr child keys out (int64 words); ~120
        # uint32 operations per threefry block, 3 blocks per split
        bound = _bound(16 * (2 + 2 * rr), 360 * rr, PEAK_OPS["int32"])
        log(f"[6] threefry_split_chain rr={rr}: kernel {k:.4f} ms {how} "
            f"({call:.4f} ms per call), plain {p:.3f} ms per call, "
            f"bound {bound[0]:.2e} ms ({bound[1]})")
        out[("threefry_split_chain", rr)] = (k, p, None, bound)
    for rr in (120, 20):
        args = _rounds_case(100, rr, torch.float32, 1e-3, seed=rr)
        fn = lambda: chol_smallk.fused_mix_mh_rounds(**args)  # noqa: E731
        call = _cuda_ms(fn, 5)
        k, how = _kernel_ms("fused_mix_mh_rounds", fn, 3, call)
        p = _cuda_ms(lambda: chol_smallk.fused_mix_mh_rounds_plain(**args), 1)
        # the library reference: cholesky_ex of each round's K Grams, R
        # calls in sequence (the rounds depend on each other); a lower
        # reference, without the Grams, solves and acceptance scan
        n, kk = 100, 4
        cz = (args["z"][None, :] + args["deltas"]).reshape(rr, kk, -1)
        grams = mixed_gram(_spec(), args["x"], unpack(_spec(), cz)[0])
        grams = grams + 1e-3 * torch.eye(n, dtype=grams.dtype, device="cuda")
        lib_fn = lambda: [torch.linalg.cholesky_ex(grams[r])  # noqa: E731
                          for r in range(rr)]
        lib_call = _cuda_ms(lib_fn, 3)
        lib, lib_how = _library_ms(lib_fn, 3, lib_call)
        d, dim = 2, 4
        nbytes = 4 * (n * d + n + dim + 3 + rr * kk * dim + rr * kk
                      + rr * (dim + 2) + rr * 2 + rr * (n + 2) * n)
        ops = rr * kk * (n * (n + 1) / 2 * (5 * d + 6) + n ** 3 / 3
                         + 2 * n * n)
        bound = _bound(nbytes, ops, PEAK_OPS[4])
        log(f"[6] fused_mix_mh_rounds n=100 K=4 R={rr} f32 stash: kernel "
            f"{k:.3f} ms {how} ({1e3 * k / rr:.1f} us/round; "
            f"{call:.3f} ms per call), plain {p:.1f} ms per call, "
            f"cholesky_ex x R {lib:.4f} ms {lib_how} ({lib_call:.3f} "
            f"ms per call), bound {bound[0]:.2e} ms ({bound[1]})")
        out[("fused_mix_mh_rounds", rr)] = (k, p, lib, bound)
    grams, ys, jit = _lanes_inputs(fit)
    for name, kern, plain, factors in (
            ("map_cloud", chol_lanes.chol_quadratics_lanes,
             chol_lanes.chol_quadratics_lanes_plain, False),
            ("map_zoom", chol_lanes.chol_quadratics_lanes,
             chol_lanes.chol_quadratics_lanes_plain, False),
            ("eb_row", chol_lanes.chol_quadratics_lanes,
             chol_lanes.chol_quadratics_lanes_plain, False),
            ("lazy_chunk", chol_lanes.chol_factors_lanes,
             chol_lanes.chol_factors_lanes_plain, True)):
        g, y, j = grams[name], ys[name], jit[name]
        b, n = g.shape[0], g.shape[-1]
        fn = lambda: kern(g, y, jitter=j)  # noqa: E731
        call = _cuda_ms(fn, 20)
        k, how = _kernel_ms(kern.__name__, fn, 20, call)
        p = _cuda_ms(lambda: plain(g, y, jitter=j), 3)
        lib_fn = lambda: _library_lanes(g, y, j)  # noqa: E731
        lib_call = _cuda_ms(lib_fn, 20)
        lib, lib_how = _library_ms(lib_fn, 20, lib_call)
        bound = _lanes_bound(b, n, g.element_size(), factors)
        log(f"[6] {kern.__name__} {name} B={b} n={n} {g.dtype}: kernel "
            f"{k:.4f} ms {how} ({call:.4f} ms per call), plain "
            f"{p:.3f} ms per call, cholesky_ex+solve_triangular {lib:.4f} "
            f"ms {lib_how} ({lib_call:.4f} ms per call), bound "
            f"{bound[0]:.2e} ms ({bound[1]})")
        out[(kern.__name__, name)] = (k, p, lib, bound)
    return out


def _record(name, source, replaces, launches, err, timed):
    k, p, lib, (bound_ms, bound_by) = timed
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k, "plain_ms": p, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib}


def main() -> int:
    name, smi = phase_device()
    phase_build()
    rng_err = phase_rng()
    rounds_err = phase_rounds()
    lanes_err = phase_lanes()
    paths = {}
    paths["full-Bayes"], fit, pred = phase_main_path()
    paths["MAP"], _, _ = phase_map()
    paths["EB"], _, _ = phase_eb()
    paths["lazy predict"] = phase_lazy(fit, pred)
    times = phase_timing(fit)
    launches = {k: sum(c[k] for c in paths.values()) for k in _counted()}
    log(f"[launches] per path: {paths}")
    kernels = [
        _record("threefry_split_chain",
                "ccgp_tpu_torch/csrc/threefry_split_chain.cu",
                "ccgp_tpu/ops/pallas_rng.py:122",
                launches["threefry_split_chain"], rng_err,
                times[("threefry_split_chain", 120)]),
        _record("fused_mix_mh_rounds", "ccgp_tpu_torch/csrc/mh_rounds.cu",
                "ccgp_tpu/ops/pallas_chol_smallk.py:1357",
                launches["fused_mix_mh_rounds"], rounds_err,
                times[("fused_mix_mh_rounds", 120)]),
        _record("chol_quadratics_lanes", "ccgp_tpu_torch/csrc/chol_lanes.cu",
                "ccgp_tpu/ops/pallas_chol_lanes.py:236",
                launches["chol_quadratics_lanes"], lanes_err,
                times[("chol_quadratics_lanes", "map_cloud")]),
        _record("chol_factors_lanes", "ccgp_tpu_torch/csrc/chol_lanes.cu",
                "ccgp_tpu/ops/pallas_chol_lanes.py:154",
                launches["chol_factors_lanes"], lanes_err,
                times[("chol_factors_lanes", "lazy_chunk")]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
