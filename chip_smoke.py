"""Smoke run of the PyTorch/CUDA port (`ccgp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA device must be present (there is no CPU path); print
     its name and `nvidia-smi`'s name and power limit;
  2. build the CUDA kernels from `ccgp_tpu_torch/csrc` (one nvcc per
     source, in parallel; sm_90a);
  3. K2: the threefry key-chain kernel against its plain PyTorch version
     (integer equality), and the fused keys-and-draws kernel
     (`chunk_draws`, the samplers' whole random stream) against its plain
     version bit for bit, with the count of bit-equal records: rr in {1,
     7, 120} x K in {1, 4, 16} x dim in {1, 4, 9} x f32 and f64 x 3 seeds,
     and the paths' shapes (the bench chunks, the 1-D round); 2^20
     normals and log-uniforms per dtype; then a report of how many of
     `rng.normal`'s values part between the CPU and the card on the same
     keys, and by how many ulps;
  4. the fused Metropolis-rounds kernel (K1, one thread-block cluster)
     against its plain version on the same inputs: equal acceptance flags
     and consumed counts, NaN stash rows in the same places, records and
     decoded stash within the stated tolerances, and the count of records
     bit-equal to the twin's (bench shape in f32 and f64, a multi-tile n
     in f32, small n = 16 and 20 in f64; K in {1, 3, 4, 5, 8, 16} x n in
     {14, 20, 100, 128, 129, 300} x f32 and f64 inside the envelope; an
     indefinite candidate rejected inside its block; a p prior);
  7. the batched Cholesky kernels (quadratics K3, factors K4; a matrix
     per group of warp lanes up to n = 32, a block per matrix on the
     register-tile core beyond) against their plain versions, bit for
     bit with NaN in the same places, with the count of bit-equal records
     and the path each n took: B in {64, 65, 128, 1728} x n in {1, 8, 14,
     16, 17, 31, 32, 33, 100, 127, 128}, f32 and f64, plus an indefinite
     and a rank-deficient batch whose NaNs must fall on the same matrices,
     and a batch with NaN above the diagonal (only the lower triangle may
     be read), each at n = 14 and 100 (both paths);
 11. the small-K kernels against their plain versions, with the count
     of bit-equal records: K5 (materialized Grams; register tiles up to
     n = 128, a cluster per Gram beyond) over K in {1, 4, 16} x n in {8,
     100, 127, 128, 129, 256, 512} and (4, 1024), K6 (in-kernel SE-mixture
     Grams, on K5's layout, logged per shape) and K7 (a whole speculative
     round: equal any_acc and consumed, every member taken first in turn
     and none) over K in {4, 16} x n in {8, 100, 256} x d in {1, 2, 9}, K
     in {4, 16} x n in {127, 128, 129}, (4, 20, 2) and (4, 100, 128), K6
     also at (4, 512, 2) and (4, 1024, 2), f32 and f64, plus indefinite
     batches (K5 at n = 40 and 150, K6 at 30 and 150) whose NaNs must fall
     on the same members, and NaN above the diagonal for K5 (n = 100 and
     300);
  5. the full-Bayes path: `fit_combined_gp` -> `predict_combined_gp` at the
     bench workload (2-D anisotropic SE x SE, tied rough rates, n = 100,
     25 x 25 lattice, speculative K = 4, n_max 5000, samp_size 1000, f32,
     jitter 1e-3, PRNGKey(7)), accuracy- and chain-guarded (the chain
     1340 / 4763 / 1844, recorded / proposals / rounds); then the same
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
     at the main paths' shapes (K2 at the bench's chunks, rr = 120 and 20,
     and the 1-D round, rr = 1, beside the split chain alone, the plain
     draws it replaced per chunk in host wall and device time, and its
     two bounds: the roofline and the chain's serial floor; K3 at the MAP cloud and zoom and an EB
     row, K4 at a lazy-predict chunk and the 1-D factor cache, each with
     the path it took; K5 at the 1-D round and at n = 100, 256,
     512 and 1024, K6 and K7 at the bench's one-round shape, K6 at n = 256,
     K8 at an EB row and the MAP cloud, K9 at the MAP cloud): device time
     under torch.profiler where it kept a record of every launch the
     wrapper counted, else the CUDA-event time per call; K1's cluster size
     and us/round;
 12. the 1-D models at full width (n = 8, 50 points, f64, function 1 on
     the `random_lhs` design `sim_1d.run` draws from PRNGKey(0), the
     --fast MCMC budget; the CPU fits in a child process beside the
     card's): `sim_1d`'s Matern x Matern and
     `sim_1d_two_families`' Matern x spline with speculative
     K = 4 (K5 once per round, K4 for the factor rebuild), and the K = 1
     sampler on Matern x Matern; each on the GPU and on the CPU (plain
     twins): the same chain, draws and predictions within 1e-7; guards
     chain_ok, rmspe < 0.3, coverage >= 0.80;
 13. the one-round SE routes: the bench workload with
     `MH_ROUNDS_CHUNKING = False` (K7 once per round, phase 5's guards),
     and at a small f64 size the chunked (K1), `body_mh` (K7) and
     `body_spec` (K6) chains, which must agree.

 14. K9 (`chol_nll`, behind `chol_quadratics(use_pallas=True)`) against
     its plain version bit for bit, with the count of bit-equal records,
     over B in {1, 4, 32, 128} x n in {1, 8, 9, 14, 17, 33, 100, 127,
     128}, and K8 (`fused_mix_quadratics`) over B in {1, 5, 128, 1728} x
     n in {14, 26, 100, 128} x d in {1, 2, 9, 16} x scale and shift
     scalar or per lane x jitter {0, 1e-8}, f32 and f64; indefinite
     batches (NaN on the same members), NaN above the diagonal (K9), and
     n = 129 / d = 17 raising;
 15. K8 and K9 through their public entry points at the shapes of the
     calls beside them: K8 on EB rows 0 and 24 (n = 14, B = 1728, f64)
     against the materialized covariance through K3 (per node logdet
     within 1e-6 and qyy within 1e-5 on both rows, row 24's log marginal
     likelihood within 1e-9), K8 and K9 on the MAP cloud (B = 128, n =
     100, f32) against an f64 oracle;
 16. the study path: `sim_2d_aniso` at its own full width (14-point
     maximin LHS, 25 x 25 lattice, n_max 5000, samp 1000, net 1000, f64,
     speculative K = 4, the mlegp baseline and the composite GP's 505
     candidates), as `python -m ccgp_tpu_torch sim_2d_aniso --f64
     --speculative 4` runs it, on the GPU and on the CPU (plain twins):
     the same chain and summaries within 1e-8, chain_ok, finite RMSPEs,
     K1 and K2 launched, the JAX package's printed summary matched; then
     the 1-D baselines on phase 12's data with `run_study`'s keys, GPU
     against CPU within phase 12's 1e-7.

 17. whiten=True: the bench workload through `fit_combined_gp(whiten=True)`
     -> `predict_combined_gp` under phase 5's guards, K2 and K4 launched
     (the factor cache rebuilt) and none of K1, K6, K7, no stash, its time
     beside phase 5's; the small f64 slice with whiten, GPU against CPU;
     the oracle check of `scripts/verify_whiten_oracle.py` at n = 768, y
     offset 1000 (f32 on the card, the bordered quadratic through K5, the
     whitened one through `whitened_quadratics`, against a float64 oracle
     of the same Grams): the whitened error no larger than the bordered;
 18. the batch-sequential ME design path at full width:
     `batch_me_design.run(Config(regenerate_first=True))` with speculative
     K = 4, f64, key 0 (14 + 7 points, 25 `optimum_lhs` starts, maxiter
     200, the 21-point refit study on the 25 x 25 lattice), on the GPU and
     on the CPU: designs in the box, the second batch above a uniform
     one, chain_ok and equal chains, designs, plug-in and summaries within
     1e-6 (coverage and calibration off the design: the lattice corners
     are design points), K1 and K2 launched, the JAX package's printed
     run matched; then k-medoids on `results/regenerated_subdesigns.npy`
     (7000 points, k = 7, 16 restarts), GPU against CPU: equal medoids,
     costs within 1e-10;
 19. the data-file case studies on the data `gv_data_root` rebuilds from
     the repo's ground-vibrations tables and on stand-ins for the files
     the repo lacks (`standin_data_root`), f64, each study's full budget:
     (a) `ground_vibrations` as the JAX package's golden run
     (`Config(sample=1, compat_mlegp=True)`, PRNGKey(1), speculative 0):
     the single GP within 1e-6 of R's archived columns, the summary at
     RESULTS_compat_mlegp.md's printed digits, its R-format table written
     and read back to the same summary; (b) `ground_vibrations` with the
     `mlegp_fit` plug-in, K = 4, (c) `heat_exchanger` with the EB scan of
     a 624-row grid (1000 nodes, n = 64; K3 once per row), (d)
     `sim_2d_iso_advanced` in both compat modes (60 rows, 1728 nodes), each
     on the GPU and on the CPU: the same chain and EB row, draws,
     predictions and summaries within 1e-8 (the heat scan on the CPU over
     the GPU's best 16 rows and every 48th), each EB scan's
     log-likelihoods within 1e-9 of a CPU scan of the same inputs, K1 and
     K2 launched, K3 once per grid row; (e) the
     golden fit through `save_fit` / `load_fit` on the CPU and the card,
     predicting as before; (f) K1 at the GV shape (K = 4, n = 50, d = 9)
     and K3 / K4 at the heat EB shape (B = 1000, n = 64) against their
     twins bit for bit, then timed as in phase 6.

 20. the multi-design sweep at full width: K2's lanes launch
     (`chunk_draws_lanes`, a block per lane) bit for bit against its plain
     version and against L single `chunk_draws` launches (100 lanes x 120
     rounds, K = 1, dim = 3, and three other shapes, f32 and f64); then
     `sim_2d_sweep.run(Config(n_designs=100))` on the stand-in
     Train_Designs (`sweep_standin_designs`), f64, key 0, Config()'s 15 x
     15 lattice and budget (n_max 3000, samp 600, net 400), every design a
     lane of the K = 1 sampler: its time and the share of each stage
     (plug-in, Laplace, the lane loop, predict), its rounds, healthy
     chains, K2's lanes launch once per 120 rounds and K4 once per design,
     the device-busy share under torch.profiler (two windows: five designs'
     Laplace fits, 360 lane-loop rounds on all lanes); lanes 0-2 on the CPU with
     the same designs and keys (equal chains, summaries within 1e-8); then
     `python -m ccgp_tpu_torch sim_2d_sweep --designs 100` (f32) and its
     medians, in a child process that runs beside phases 3-14 (whose
     checks do not depend on time) and is collected before phase 5;
 21. the parallel surface: `graft_entry.dryrun_multichip(4)` on the card
     four times over against the one-device mesh (the training step and
     the four sharded functions, 1e-4), HMC on the sweep's first design's
     posterior on the card against the CPU (f64, 200 warmup iterations and
     200 draws, 8 leapfrog steps: the first draw where the chains part,
     if they do; then
     50 draws without warmup, which must stay within 1e-6), and
     `entry()`'s forward (float32 finite; float64 card against CPU within
     1e-10);
 22. the options and names the port took over last, each sub-phase's
     seconds logged: (a) `sim_2d_aniso.run(design=D)` at Config()'s full
     budget (n = 14, n_max 5000, samp 1000, f64, K = 4), D the first
     stand-in Train_Design (`sweep_standin_designs`), on the card and the
     CPU (equal counters; draws, predictions and summaries within 1e-7,
     phase 12's limit: the chain carries two BFGS stopping points; K1 and
     K2 launched), and `run(design=<the design run()
     draws>)` against phase 16's `run()` bit for bit; (b) `run_study(
     run_single=False, cgp_candidates=105, on_unconverged="raise")` on
     (a)'s data (the combined GP (a)'s bit for bit), a starved chain
     raising under "raise" and silent under "ignore"; (c) `cgp_fit(
     jackknife=False, num_starts=3, ...)` and `mlegp_fit(n_random=4,
     maxiter=100, log_theta_low=-8, log_theta_high=8)` card against CPU
     (1e-8; theta 1e-6, sigma^2 and beta 1e-7); (d)
     `predictive_moments(solve_mode="inv_matmul")` against "trsm" at the
     bench shape (phase 5's 1000 draws, n = 100, t = 625, f64; JAX's 1e-8
     and 1e-12), both timed; (e) `multi_chain_metropolis` on the mesh
     ["cuda:0", "cpu"] (a host thread per device) against each shard's
     chains on its device alone, bit for bit, K2's lanes launch on the
     card's shard, and JAX's one-design `sharded_design_sweep` on cuda:0 x
     2 against the designs one by one; (f) K2 at K dim = 2^24 (rr = 1,
     f32, 64-bit indices) bit-equal to its twin, timed. Seconds on one
     H100 80GB HBM3 at 700 W, the CPU twins beside phase 12: (a) and (b)
     17.0, (c) 3.9, (d) 0.2, (e) 9.7, (f) 0.5, the phase 31.2 of the
     script's 834.

 23. Geweke's p-value on the card (`ops.geweke`, csrc/geweke.cu; after
     phase 6, before the paths of many small launches): at the fit cells'
     shapes (n = 1000; dim 4 in f32, dim 3 in f64), 12 AR(1) windows each
     read in place from a chain buffer against the plain path the drivers
     took before (window read back, p-value on the CPU; 1e-12 relative in
     f64, 1e-4 in f32, the same decision against 0.5), then the kernel's
     device and call time, a check on the card with its read-back, the
     plain version on the card and the CPU path per check, and the serial
     floor; phase 5's bench fit must launch it.

The CPU sides of phases 16, 19 (all but the heat exchanger's, which scans
the card's rows), 21's HMC and 22a run in a child process (`_cpu_twins`)
beside phase 12's card fits, as phase 12's own CPU fits do; the card's
results are compared with them where the phases run.

Every path (5, 8, 9, 10, 12, 13, 15, 16, 17, 18, 19, 20, 21, 22) runs with all
launch counters set to 0 just before it and read just after; each must
launch its kernels (K2's fused kernel once per chunk, 38 in the bench fit,
and once per round on the one-round and 1-D routes; its lanes launch once
per 120 rounds of the sweep). The last lines are a JSON object of kernel
records (K1-K9, K2's lanes launch and Geweke's kernel), the card's name and power limit,
and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import functools
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
# memory 3.35 TB/s; int32 16.7 TOP/s (64 INT32 lanes per SM x 132 SMs x
# 1.98 GHz). Floating point by the kind of work: a factorization's and a
# solve's multiply-adds could run on the tensor cores, which reach 67
# TFLOP/s in f64 (f32 has no full-precision tensor-core rate, so 67 outside
# them); elementwise work (a Gram's distances and exp) runs outside them,
# at 67 TFLOP/s in f32 and 34 in f64.
HBM_BPS = 3.35e12
PEAK_OPS = {4: 67e12, 8: 67e12, "int32": 16.7e12}
PEAK_VEC = {4: 67e12, 8: 34e12}


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


# phase 3's grid for the fused keys-and-draws kernel, then the shapes of
# the paths: the bench chunk and the 1-D round
DRAWS_GRID = [(rr, kk, dim, dtype) for dtype in (torch.float32, torch.float64)
              for rr in (1, 7, 120) for kk in (1, 4, 16) for dim in (1, 4, 9)]
DRAWS_PATHS = [(120, 4, 4, torch.float32), (20, 4, 4, torch.float32),
               (1, 4, 1, torch.float64), (1, 4, 4, torch.float32)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of b, per element."""
    a, b = a.double(), b.to(a.device)
    ulp = torch.nextafter(b.abs(), torch.tensor(math.inf, dtype=b.dtype,
                                               device=b.device)) - b.abs()
    return (a - b.double()).abs() / ulp.double()


def phase_rng():
    """K2: the split chain and the fused keys-and-draws kernel against
    their plain versions, integer- and bit-equal; 2^20 normals and
    log-uniforms per dtype; then a report of where the CPU's normals part
    from the card's on the same keys."""
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

    nbit, total = {}, {}
    for rr, kk, dim, dtype in DRAWS_GRID + DRAWS_PATHS:
        for seed in (0, 7, 123456789):
            key = rng.PRNGKey(seed, device="cuda")
            got = rng.chunk_draws(key, rr, kk, dim, dtype)
            ref = rng.chunk_draws_plain(key, rr, kk, dim, dtype)
            torch.cuda.synchronize()
            eq = (torch.equal(got[0], ref[0])
                  and all(g.shape == r.shape and torch.equal(_bits(g), _bits(r))
                          for g, r in zip(got[1:], ref[1:])))
            nbit[dtype] = nbit.get(dtype, 0) + eq
            total[dtype] = total.get(dtype, 0) + 1
            if not eq:
                diff = max(float(_ulps(g, r).max())
                           for g, r in zip(got[1:], ref[1:]))
                raise AssertionError(
                    f"chunk_draws differs from its plain version at rr={rr} "
                    f"K={kk} dim={dim} {dtype} seed={seed} (keys equal: "
                    f"{torch.equal(got[0], ref[0])}, up to {diff:g} ulps)")
    log(f"[3] chunk_draws == plain bit for bit: f32 {nbit[torch.float32]} "
        f"of {total[torch.float32]} records, f64 {nbit[torch.float64]} of "
        f"{total[torch.float64]} (rr in {{1,7,120}} x K in {{1,4,16}} x dim "
        f"in {{1,4,9}} x 3 seeds, and the paths' shapes (120, 4, 4) f32, "
        f"(20, 4, 4) f32, (1, 4, 1) f64, (1, 4, 4) f32)")
    # erfinv and log as PyTorch's CUDA kernels compute them: 2^20 each
    for dtype in (torch.float32, torch.float64):
        key = rng.PRNGKey(2024, device="cuda")
        got = rng.chunk_draws(key, 16, 1 << 16, 1, dtype)
        ref = rng.chunk_draws_plain(key, 16, 1 << 16, 1, dtype)
        for what, g, r in (("normals", got[1], ref[1]),
                           ("log-uniforms", got[2], ref[2])):
            if not torch.equal(_bits(g), _bits(r)):
                raise AssertionError(
                    f"chunk_draws {what} {dtype}: "
                    f"{int((_bits(g) != _bits(r)).sum())} of 2^20 differ")
    log("[3] chunk_draws: 2^20 normals and 2^20 log-uniforms per dtype "
        "bit-equal to torch.special.erfinv and torch.log on the card")

    # a report, not a check: the CPU's normals (its erfinv) against the
    # card's on the same keys; the CPU path stays held to JAX
    for dtype in (torch.float32, torch.float64):
        key = rng.PRNGKey(2024, device="cpu")
        _, k1s, _ = rng.threefry_split_chain_plain(key, 16)
        cpu = rng.normal(k1s, (1 << 16,), dtype)
        gpu = rng.normal(k1s.cuda(), (1 << 16,), dtype).cpu()
        ulps = _ulps(cpu, gpu)
        nz = ulps > 0
        lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                                   torch.tensor(0.0, dtype=dtype)))
        u = rng.uniform(k1s, (1 << 16,), dtype, lo, 1.0)
        ug = rng.uniform(k1s.cuda(), (1 << 16,), dtype, lo, 1.0)
        ecpu = torch.special.erfinv(u)
        egpu = torch.special.erfinv(ug).cpu()
        log(f"[3] rng.normal on the CPU vs the card, same keys, {dtype}: "
            f"{int(nz.sum())} of {cpu.numel()} values differ, by up to "
            f"{float(ulps.max()):g} ulps (median of those "
            f"{float(ulps[nz].median()) if bool(nz.any()) else 0.0:g}); "
            f"the uniforms are equal: {torch.equal(u, ug.cpu())}; "
            f"erfinv of them differs on {int((ecpu != egpu).sum())}")
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


def _rounds_case(n, rr, dtype, jitter, seed, kk=4, indefinite=False,
                 jeffreys=False):
    """K1's inputs on the bench model (2-D anisotropic SE x SE, tied rough
    rates). jeffreys: a `JeffreysUnit` prior on p as well. indefinite: the
    state sits at rough rates (e^4) and every round's candidate 0 steps to
    smooth ones (e^-4), whose near-singular Gram the negative jitter makes
    indefinite: a NaN log-posterior, rejected, while the rough candidates
    stay positive definite; lp_val starts at -1e30, so every finite
    candidate 0 would be taken."""
    from ccgp_tpu_torch.models.likelihood import cand_model_for
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.priors import (InverseGamma, JeffreysUnit,
                                              LogNormal)
    from ccgp_tpu_torch.ops import kernels

    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    dim = 4
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device="cuda")  # noqa: E731
    model = cand_model_for(spec, t(x), LogNormal(-1.0, 1.0),
                           InverseGamma(3, 4),
                           JeffreysUnit() if jeffreys else None)
    z, lpv = [0.6, 0.4, 0.1, -0.2], -1e6
    deltas = 0.25 * r.normal(size=(rr * kk, dim))
    if indefinite:
        z, lpv, jitter = [4.0, 4.0, 0.1, -0.2], -1e30, -0.01
        deltas[0::kk, :2] -= 8.0
    args = dict(x=t(x), y=t(f2(x)), z=t(z),
                lp_val=t(lpv), lp_beta=t(0.0), sigma2=t(0.05),
                deltas=t(deltas),
                log_u=t(np.log(r.uniform(size=(rr, kk)))), model=model,
                jitter=jitter, stash=True)
    return args


def _compare_rounds(args, rtol, label, indefinite=False, tag="[4]"):
    """K1 against its twin on the same inputs: equal acc and consumed, NaN
    stash rows in the same places, records and decoded stash within rtol.
    Returns (max abs error, records bit-equal to the twin's)."""
    from ccgp_tpu_torch.ops import chol_smallk
    from ccgp_tpu_torch.predict.factors import decode_stash

    got = chol_smallk.fused_mix_mh_rounds(**args)
    ref = chol_smallk.fused_mix_mh_rounds_plain(**args)
    torch.cuda.synchronize()
    if not torch.equal(got["acc"], ref["acc"]):
        raise AssertionError(f"{label}: acc differs")
    if not torch.equal(got["consumed"], ref["consumed"]):
        raise AssertionError(f"{label}: consumed differs")
    if not torch.equal(torch.isnan(got["stash"]), torch.isnan(ref["stash"])):
        raise AssertionError(f"{label}: NaN stash entries differ")
    if indefinite and not bool((ref["consumed"] >= 2).all()):
        raise AssertionError(f"{label}: the indefinite candidate was taken")
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
    bits = int((got["rec"] == ref["rec"]).all(1).sum())
    if not (err_rec <= rtol and err_stash <= rtol):
        raise AssertionError(f"{label}: rec err {err_rec:.3g}, stash err "
                             f"{err_stash:.3g} > {rtol:g}")
    log(f"{tag} {label}: acc/consumed equal ({int(acc.sum())}/"
        f"{acc.numel()} accepted), rec rel err {err_rec:.3g}, stash rel "
        f"err {err_stash:.3g} (tol {rtol:g}), {bits}/{acc.numel()} records "
        f"bit-equal")
    return abs_err, bits


ROUNDS_K = (1, 3, 4, 5, 8, 16)
ROUNDS_N = (14, 20, 100, 128, 129, 300)


def phase_rounds():
    """K1 against its twin: the bench shape (R = 20 and 120 in f32, R = 20
    in f64), n = 300 (f32) and 16 (f64), phases 5 and 13's small slice,
    and the cluster's cases: K in ROUNDS_K (one block, uneven splits, two
    candidates per block) x n in ROUNDS_N (the study's 14, the single
    tile's edge 128, the multi-tile core from 129) x f32 and f64, inside
    `dispatch_ok`, plus an indefinite candidate and a `JeffreysUnit` p
    prior in each dtype. Returns the largest absolute error of the first
    three f32 cases."""
    from ccgp_tpu_torch.ops.chol_smallk import dispatch_ok

    errs, bits, recs = [], 0, 0

    def check(args, tol, label, indefinite=False):
        nonlocal bits, recs
        err, b = _compare_rounds(args, tol, label, indefinite)
        bits += b
        recs += args["log_u"].shape[0]
        return err

    for rr in (20, 120):
        errs.append(check(_rounds_case(100, rr, torch.float32, 1e-3, seed=rr),
                          F32_RTOL, f"bench shape n=100 K=4 R={rr} f32"))
    errs.append(check(_rounds_case(300, 4, torch.float32, 1e-3, seed=3),
                      F32_RTOL, "multi-tile n=300 K=4 R=4 f32"))
    check(_rounds_case(16, 6, torch.float64, 1e-9, seed=2), F64_RTOL,
          "small n=16 K=4 R=6 f64")
    check(_rounds_case(20, 6, torch.float64, 1e-6, seed=5), F64_RTOL,
          "phases 5 and 13's small slice n=20 K=4 R=6 f64")
    check(_rounds_case(100, 20, torch.float64, 1e-6, seed=4), F64_RTOL,
          "bench n=100 K=4 R=20 f64")
    for kk in ROUNDS_K:
        for n in ROUNDS_N:
            if not dispatch_ok(n, kk):
                continue
            for dtype, tol, jit in ((torch.float32, F32_RTOL, 1e-3),
                                    (torch.float64, F64_RTOL, 1e-8)):
                rr = 6 if n <= 128 else 3
                check(_rounds_case(n, rr, dtype, jit, seed=n + kk, kk=kk),
                      tol, f"n={n} K={kk} R={rr} {dtype}")
    for dtype, tol in ((torch.float32, F32_RTOL), (torch.float64, F64_RTOL)):
        check(_rounds_case(14, 6, dtype, 0.0, seed=11, kk=5, indefinite=True),
              tol, f"indefinite candidate 0 n=14 K=5 R=6 {dtype}",
              indefinite=True)
        check(_rounds_case(100, 20, dtype, 1e-3, seed=12, jeffreys=True),
              tol, f"p prior JeffreysUnit n=100 K=4 R=20 {dtype}")
    log(f"[4] K1: {bits} of {recs} records bit-equal to the twin's")
    return max(errs)


def _spec():
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.ops import kernels

    return MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)


def _fit_predict(x, y, grid, seed, dtype, device, jitter, draw_chunk=None,
                 whiten=False, **cfg):
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
                          draw_chunk=draw_chunk, whiten=whiten, device=device)
    pred = predict_combined_gp(spec, fit, t(x), t(grid), kp,
                               draw_chunk=draw_chunk or 64, device=device)
    return fit, pred


def _counted():
    """Every kernel wrapper, by the name its launch counter reports."""
    from ccgp_tpu_torch.ops import (
        chol_lanes, chol_nll, chol_smallk, geweke, gram_chol, rng)

    return {"threefry_split_chain": rng.threefry_split_chain,
            "chunk_draws": rng.chunk_draws,
            "chunk_draws_lanes": rng.chunk_draws_lanes,
            "fused_mix_mh_rounds": chol_smallk.fused_mix_mh_rounds,
            "chol_quadratics_lanes": chol_lanes.chol_quadratics_lanes,
            "chol_factors_lanes": chol_lanes.chol_factors_lanes,
            "chol_quadratics_smallk": chol_smallk.chol_quadratics_smallk,
            "fused_mix_quadratics_smallk":
                chol_smallk.fused_mix_quadratics_smallk,
            "fused_mix_mh_round": chol_smallk.fused_mix_mh_round,
            "fused_mix_quadratics": gram_chol.fused_mix_quadratics,
            "chol_nll": chol_nll.chol_nll,
            "geweke_pvalue": geweke.geweke_pvalue}


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
# recorded / proposals / rounds of the bench chain (key 7, f32), the same
# on the card in every run since the port began
BENCH_CHAIN = (1340, 4763, 1844)
BENCH_CHUNKS = 38   # its chunks: one launch of chunk_draws and of K1 each
FULL_BAYES_CALLS = 5


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
    chain = (mc.n_recorded, mc.n_proposals, mc.n_rounds)
    if chain != BENCH_CHAIN:
        raise AssertionError(f"the bench chain moved: {chain}, expected "
                             f"{BENCH_CHAIN}")
    _require_launched(launches, ("chunk_draws", "fused_mix_mh_rounds",
                                 "geweke_pvalue"), "full-Bayes path")
    if (launches["chunk_draws"], launches["fused_mix_mh_rounds"]) != (
            BENCH_CHUNKS, BENCH_CHUNKS):
        raise AssertionError(f"the bench fit must draw and run its rounds "
                             f"in {BENCH_CHUNKS} chunks: {launches}")

    # timed runs (same key, so the same chain), CUDA events: the spread of
    # FULL_BAYES_CALLS calls, the median as the time
    times, walls = [], []
    for _ in range(FULL_BAYES_CALLS):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        fit2, _ = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                               **BENCH_CFG)
        ev1.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        times.append(ev0.elapsed_time(ev1))
        if fit2.mcmc.n_recorded != mc.n_recorded:
            raise AssertionError("the timed run took another chain")
    ms = float(np.median(times))
    log(f"[5] full-Bayes fit+predict over {FULL_BAYES_CALLS} calls (CUDA "
        f"events): median {ms:.1f} ms, min {min(times):.1f}, max "
        f"{max(times):.1f} (each: {', '.join(f'{t:.1f}' for t in times)}); "
        f"wall median {float(np.median(walls)):.1f} ms; "
        f"{1e3 * ms / mc.n_rounds:.1f} us/round over {mc.n_rounds} rounds")
    _log_profile("[5] full-Bayes", ms, lambda: _fit_predict(
        x, y, grid, 7, torch.float32, "cuda", 1e-3, **BENCH_CFG), 1,
        warm=False)

    small_slice_gpu_vs_cpu("[5]")
    return launches, fit, pred, ms


SMALL_RTOL = 1e-6   # the small f64 slice, GPU against CPU


def small_slice_gpu_vs_cpu(tag, whiten=False):
    """Phase 5's slice at a small f64 size (n = 20, a 6 x 6 lattice,
    n_max 400, samp = net = 120, key 1, jitter 1e-6) on the GPU (kernels)
    and on the CPU (plain twins): equal chain counters, draws and
    predictions within SMALL_RTOL."""
    xs = np.random.default_rng(0).uniform(size=(20, 2))
    ys = np.sin(5 * xs[:, 0]) + np.cos(3 * xs[:, 1])
    u = np.linspace(0, 1, 6)
    gs = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    small = dict(n_max=400, samp_size=120, net_samp_size=120, whiten=whiten)
    fg, pg = _fit_predict(xs, ys, gs, 1, torch.float64, "cuda", 1e-6, **small)
    fc, pc = _fit_predict(xs, ys, gs, 1, torch.float64, "cpu", 1e-6, **small)
    for a in ("n_recorded", "n_proposals", "n_rounds", "converged"):
        if getattr(fg.mcmc, a) != getattr(fc.mcmc, a):
            raise AssertionError(f"{tag} small slice: {a} differs GPU vs CPU")
    err_z = _rel_err(fg.zs, fc.zs)
    err = max(_rel_err(getattr(pg, a), getattr(pc, a))
              for a in ("mean", "lower", "upper"))
    if not (err <= SMALL_RTOL and err_z <= SMALL_RTOL):
        raise AssertionError(f"{tag} small slice: GPU vs CPU rel err "
                             f"{err:.3g}, draws {err_z:.3g}")
    log(f"{tag} small f64 slice{' (whiten)' if whiten else ''} GPU == CPU: "
        f"n_recorded={fg.mcmc.n_recorded} n_rounds={fg.mcmc.n_rounds}, "
        f"draws rel err {err_z:.3g}, mean/lower/upper rel err {err:.3g} "
        f"(tol {SMALL_RTOL:g})")


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


def _lanes_equal(got: dict, ref: dict) -> bool:
    """True when every output equals the twin's bit for bit (+0 and -0 as
    equal), NaN in the same places."""
    def same(a, b):
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(0.0, math.inf, -math.inf),
                                b.nan_to_num(0.0, math.inf, -math.inf)))
    return set(got) == set(ref) and all(same(got[k], ref[k]) for k in ref)


def _compare_lanes(g, y, jitter, label, expect_nan=None):
    """Both kernels against their plain versions on the card. Returns the
    largest absolute difference over finite entries, the number of
    matrices whose logdet is NaN, and the labels of the kernels whose
    outputs were not bit-equal to the twin's."""
    from ccgp_tpu_torch.ops import chol_lanes

    abs_err, unequal = 0.0, []
    for kern, plain in ((chol_lanes.chol_quadratics_lanes,
                         chol_lanes.chol_quadratics_lanes_plain),
                        (chol_lanes.chol_factors_lanes,
                         chol_lanes.chol_factors_lanes_plain)):
        got = kern(g, y, jitter=jitter)
        ref = plain(g, y, jitter=jitter)
        torch.cuda.synchronize()
        if not _lanes_equal(got, ref):
            unequal.append(f"{kern.__name__} {label}")
        for k in set(got) & set(ref):
            fin = torch.isfinite(ref[k]) & torch.isfinite(got[k])
            if bool(fin.any()):
                abs_err = max(abs_err, float(torch.max(torch.abs(
                    got[k][fin] - ref[k][fin]))))
        nan = ~torch.isfinite(got["logdet"])
        if expect_nan is not None and not torch.equal(nan.cpu(), expect_nan):
            raise AssertionError(f"{label}: NaN on the wrong matrices")
    return abs_err, int(nan.sum()), unequal


LANES_N = (1, 8, 14, 16, 17, 31, 32, 33, 100, 127, 128)
LANES_B = (64, 65, 128, 1728)   # 65: a part-filled warp group
LANES_JITTER = {torch.float32: 1e-3, torch.float64: 1e-6}


def phase_lanes():
    from ccgp_tpu_torch.ops import chol_lanes

    abs_errs, unequal = [], []
    records = {dt: 0 for dt in LANES_JITTER}
    paths = {dt: {} for dt in LANES_JITTER}
    for n in LANES_N:
        for b in LANES_B:
            g64, y64 = se_grams(b, n, seed=b + n)
            for dtype, jitter in LANES_JITTER.items():
                g, y = (torch.tensor(a, dtype=dtype, device="cuda")
                        for a in (g64, y64))
                ae, _, bad = _compare_lanes(g, y, jitter,
                                            f"B={b} n={n} {dtype}")
                abs_errs.append(ae)
                unequal += bad
                records[dtype] += 2
                paths[dtype][n] = chol_lanes.lanes_layout(n, b, dtype)[:2]
    for dtype in LANES_JITTER:
        bad = sum(str(dtype) in u for u in unequal)
        log(f"[7] K3 and K4 == plain bit for bit (NaN in the same places) "
            f"for B in {set(LANES_B)} x n in {set(LANES_N)}, {dtype}: "
            f"{records[dtype] - bad} of {records[dtype]} records; (lanes "
            f"per matrix, 0 on the tile path; threads per block) by n: "
            + ", ".join(f"{n}: {p}" for n, p in paths[dtype].items()))
    for dtype, jitter in LANES_JITTER.items():
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        # only the lower triangle is read, on both paths: NaN above the
        # diagonal changes no output
        for n in (14, 100):
            g, y = (t(a) for a in se_grams(128, n, seed=5))
            junk = g.clone()
            iu = torch.triu_indices(n, n, 1, device="cuda")
            junk[:, iu[0], iu[1]] = math.nan
            for kern in (chol_lanes.chol_quadratics_lanes,
                         chol_lanes.chol_factors_lanes):
                ref, got = (kern(g, y, jitter=jitter),
                            kern(junk, y, jitter=jitter))
                if not _lanes_equal(got, ref):
                    raise AssertionError(f"{kern.__name__} n={n} {dtype}: "
                                         f"the upper triangle changed an "
                                         f"output")
        log(f"[7] {dtype}: NaN above the diagonal changes no output of "
            f"either kernel (B=128, n = 14 and 100)")
        # odd members: rank n/2 minus 1e-2 I (a negative pivot, NaN);
        # even members plus 1e-2 I (finite); and the rank-n/2 Grams alone
        # (no jitter): NaN wherever roundoff turns a zero pivot negative,
        # on the same matrices in kernel and twin
        for n in (14, 100):
            r = np.random.default_rng(3)
            v = r.normal(size=(128, n, n // 2))
            low = v @ np.swapaxes(v, 1, 2) / n
            shift = np.where(np.arange(128) % 2 == 1, -1e-2, 1e-2)
            g = low + shift[:, None, None] * np.eye(n)
            y = r.normal(size=n)
            ae, nan, bad = _compare_lanes(
                t(g), t(y), 0.0, f"indefinite n={n} {dtype}",
                expect_nan=torch.arange(128) % 2 == 1)
            abs_errs.append(ae)
            unequal += bad
            ae, nan_rd, bad = _compare_lanes(t(low), t(y), 0.0,
                                             f"rank-deficient n={n} {dtype}")
            abs_errs.append(ae)
            unequal += bad
            log(f"[7] {dtype} n={n}: indefinite batch NaN on the {nan} odd "
                f"members; rank-deficient batch (jitter 0) NaN on {nan_rd} "
                f"of 128, the same in kernel and twin")
    if unequal:
        raise AssertionError(f"K3/K4 not bit-equal to the twin on "
                             f"{len(unequal)} records: {unequal[:8]}")
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
                                 "chunk_draws"), "lazy path")
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


# ---------------------------------------------------------------------------
# the small-K kernels (K5 quadratics of materialized Grams, K6 quadratics
# of in-kernel SE-mixture Grams, K7 one whole speculative round)
# ---------------------------------------------------------------------------

def _compare_quads(got, ref, tol, label):
    """Largest relative and absolute errors of {logdet, qyy, qoy, qoo};
    raises past tol or where NaNs differ. Also says whether all are
    bit-equal (NaNs in the same places)."""
    err = abs_err = 0.0
    equal = True
    for k in ref:
        e = _rel_err(got[k], ref[k])
        if not e <= tol:
            raise AssertionError(f"{label}: {k} rel err {e:.3g} > {tol:g} "
                                 f"(or NaNs differ)")
        fin = torch.isfinite(ref[k])
        if bool(fin.any()):
            abs_err = max(abs_err, float(torch.max(torch.abs(
                got[k][fin] - ref[k][fin]))))
        equal = equal and torch.equal(torch.nan_to_num(got[k]),
                                      torch.nan_to_num(ref[k]))
        err = max(err, e)
    return err, abs_err, equal


def mix_case(kk, n, d, dtype, seed, indefinite=False):
    """K6/K7 inputs: x (n, d) uniform, y, rates r1 = e^N(0,1) per axis and
    r2 = (1 + e^N(0,1)) r1 (the tied rough rate), p in (0.05, 0.95); with
    indefinite=True the odd members get a negative smooth rate (an
    indefinite Gram)."""
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, d))
    r1 = np.exp(r.normal(size=(kk, d)))
    r2 = (1.0 + np.exp(r.normal(size=(kk, 1)))) * r1
    if indefinite:
        r1[1::2] = -5.0
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device="cuda")  # noqa: E731
    rnd = dict(extra=t(r.normal(size=kk)), log_scale=t(r.normal(size=kk)),
               cands=t(r.normal(size=(kk, d + 2))), lp_val=t(-1e6),
               lp_beta=t(0.3), log_u=t(np.log(r.uniform(size=kk))))
    return dict(x=t(x), y=t(np.sin(5 * x[:, 0])), r1=t(r1), r2=t(r2),
                p=t(r.uniform(0.05, 0.95, size=kk))), rnd


def _compare_round(args, rnd, tol, label):
    from ccgp_tpu_torch.ops import chol_smallk

    got = chol_smallk.fused_mix_mh_round(**args, **rnd)
    ref = chol_smallk.fused_mix_mh_round_plain(**args, **rnd)
    torch.cuda.synchronize()
    if bool(got[3]) != bool(ref[3]) or int(got[4]) != int(ref[4]):
        raise AssertionError(f"{label}: K7 any_acc / consumed differ")
    err = max(_rel_err(a, b) for a, b in zip(got[:3], ref[:3]))
    if not err <= tol:
        raise AssertionError(f"{label}: K7 rel err {err:.3g} > {tol:g}")
    abs_err = max(float(torch.max(torch.abs(a - b)))
                  for a, b in zip(got[:3], ref[:3]))
    equal = all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3]))
    return err, abs_err, equal, int(got[4])


def indefinite_batch(n=40, rank=20):
    """16 Grams of size n and the given rank whose odd members get -1e-2 I
    (a negative pivot: NaN) and even members +1e-2 I, and a response."""
    r = np.random.default_rng(4)
    v = r.normal(size=(16, n, rank))
    shift = np.where(np.arange(16) % 2 == 1, -1e-2, 1e-2)
    return (v @ np.swapaxes(v, 1, 2) / n + shift[:, None, None]
            * np.eye(n)), r.normal(size=n)


def phase_smallk():
    from ccgp_tpu_torch.ops import chol_smallk

    abs5 = abs6 = abs7 = 0.0
    for dtype, jitter in ((torch.float32, 1e-3), (torch.float64, 1e-6)):
        tol = F32_RTOL if dtype == torch.float32 else F64_RTOL
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        errs, bit, nbit, cores = [], True, 0, set()
        shapes = [(kk, n) for kk in (1, 4, 16)
                  for n in (8, 100, 127, 128, 129, 256, 512)]
        for kk, n in shapes + [(4, 1024)]:
            g, y = (t(a) for a in se_grams(kk, n, seed=kk + n))
            got = chol_smallk.chol_quadratics_smallk(g, y, jitter=jitter)
            ref = chol_smallk.chol_quadratics_smallk_plain(g, y,
                                                           jitter=jitter)
            torch.cuda.synchronize()
            e, ae, eq = _compare_quads(got, ref, tol,
                                       f"K5 K={kk} n={n} {dtype}")
            errs.append(e)
            abs5 = max(abs5, ae)
            bit = bit and eq
            nbit += eq
            cores.add(chol_smallk.smallk_layout("chol_quadratics_smallk", n,
                                                kk, dtype)[:2])
        log(f"[11] K5 chol_quadratics_smallk == plain for K in {{1,4,16}} x "
            f"n in {{8,100,127,128,129,256,512}} and (4, 1024), {dtype}: max "
            f"rel err {max(errs):.3g} (tol {tol:g}); bit-equal: {bit} "
            f"({nbit} of {len(errs)}); (cluster, blocks) seen "
            f"{sorted(cores)}")
        # only the lower triangle is read, on both cores; an indefinite
        # batch gives NaN on the same members in kernel and twin
        for n in (100, 300):
            g, y = (t(a) for a in se_grams(4, n, seed=5))
            iu = torch.triu_indices(n, n, 1, device="cuda")
            junk = g.clone()
            junk[:, iu[0], iu[1]] = math.nan
            a = chol_smallk.chol_quadratics_smallk(g, y, jitter=jitter)
            b = chol_smallk.chol_quadratics_smallk(junk, y, jitter=jitter)
            if not all(torch.equal(a[k], b[k]) for k in a):
                raise AssertionError(f"K5 n={n}: the upper triangle changed "
                                     f"an output")
        for n, rank in ((40, 20), (150, 60)):
            g, y = (t(a) for a in indefinite_batch(n, rank))
            got = chol_smallk.chol_quadratics_smallk(g, y)
            _, ae, _ = _compare_quads(
                got, chol_smallk.chol_quadratics_smallk_plain(g, y), tol,
                f"K5 indefinite n={n} {dtype}")
            abs5 = max(abs5, ae)
            nan = ~torch.isfinite(got["logdet"])
            if not torch.equal(nan.cpu(), torch.arange(16) % 2 == 1):
                raise AssertionError(f"K5 n={n}: NaN on the wrong members")
        log(f"[11] K5 {dtype}: NaN above the diagonal changes no output at "
            f"n = 100 and 300; indefinite batches at n = 40 and 150 are NaN "
            f"on their {int(nan.sum())} odd members in kernel and twin")

        errs6, errs7, nbit6, bit7, consumed = [], [], 0, True, set()
        cores6 = {}
        cases = [(kk, n, d) for kk in (4, 16) for n in (8, 100, 256)
                 for d in (1, 2, 9)]
        # the edge of K7's cluster core, phase 13's small slice, and the
        # widest x the kernels hold
        cases += [(kk, n, 2) for kk in (4, 16) for n in (127, 128, 129)]
        cases += [(4, 20, 2), (4, 100, chol_smallk.MAX_D)]
        # K6's panel core to the envelope's edge (rows in the global
        # workspace at n = 1024 in f64); the gates send K7 n <= 256 only
        cases += [(4, 512, 2), (4, 1024, 2)]
        for kk, n, d in cases:
            label = f"K={kk} n={n} d={d} {dtype}"
            args, rnd = mix_case(kk, n, d, dtype, seed=kk + n + d)
            got = chol_smallk.fused_mix_quadratics_smallk(**args,
                                                          jitter=jitter)
            ref = chol_smallk.fused_mix_quadratics_smallk_plain(**args,
                                                                jitter=jitter)
            torch.cuda.synchronize()
            e, ae, eq = _compare_quads(got, ref, tol, "K6 " + label)
            errs6.append(e)
            abs6 = max(abs6, ae)
            nbit6 += eq
            cores6[(kk, n)] = chol_smallk.smallk_layout(
                "fused_mix_quadratics_smallk", n, kk, dtype)[:2]
            if n > 256:
                continue
            # lp_val thresholds that accept some, any or none; then each
            # member in turn taken first (log_u -inf there, +inf before it)
            rounds = [(t(lp), rnd["log_u"]) for lp in (-1e6, 0.0, 1e6)]
            rounds += [(t(-1e6), t(np.where(np.arange(kk) < m, np.inf,
                                            -np.inf))) for m in range(kk)]
            for lp, log_u in rounds:
                e, ae, eq, c = _compare_round(
                    dict(args, jitter=jitter), dict(rnd, lp_val=lp,
                                                    log_u=log_u),
                    tol, label + f" lp_val={float(lp):g}")
                errs7.append(e)
                abs7 = max(abs7, ae)
                bit7 = bit7 and eq
                consumed.add(c)
        log(f"[11] K6 fused_mix_quadratics_smallk == plain and K7 "
            f"fused_mix_mh_round == plain (any_acc and consumed equal; "
            f"consumed seen {sorted(consumed)}) for K in {{4,16}} x n in "
            f"{{8,100,256}} x d in {{1,2,9}}, K in {{4,16}} x n in "
            f"{{127,128,129}} x d = 2, (4, 20, 2) and (4, 100, "
            f"{chol_smallk.MAX_D}); K6 also at (4, 512, 2) and (4, 1024, 2); "
            f"{dtype}: max rel err "
            f"{max(errs6):.3g} / {max(errs7):.3g} (tol {tol:g}); "
            f"bit-equal: K6 {nbit6} of {len(errs6)}, K7 {bit7}")
        log(f"[11] K6 (cluster, blocks) per (K, n), {dtype}: "
            + ", ".join(f"{kn}: {c}" for kn, c in sorted(cores6.items())))
        # an indefinite batch on K6's panel core (n = 150) and on its
        # register-tile core (n = 30, the batch K7 takes below)
        eq6 = []
        for n in (150, 30):
            args, rnd = mix_case(8, n, 2, dtype, seed=9, indefinite=True)
            args["jitter"] = 1e-2
            got = chol_smallk.fused_mix_quadratics_smallk(**args)
            eq6.append(_compare_quads(
                got, chol_smallk.fused_mix_quadratics_smallk_plain(**args),
                tol, f"K6 indefinite n={n} {dtype}")[2])
            nan = ~torch.isfinite(got["logdet"])
            if not torch.equal(nan.cpu(), torch.arange(8) % 2 == 1):
                raise AssertionError(f"K6 n={n}: NaN on the wrong members")
        rnd.update(lp_val=t(-1e30), extra=t(np.zeros(8)),
                   log_scale=t(np.zeros(8)),
                   log_u=t(np.r_[np.inf, np.full(7, -1.0)]))
        _, _, _, c = _compare_round(args, rnd, tol, f"K7 indefinite {dtype}")
        if c != 3:
            raise AssertionError("K7 took a NaN member or skipped member 2")
        log(f"[11] K6/K7 {dtype}: an indefinite batch is NaN on its 4 odd "
            f"members in kernel and twin (K6 at n = 150 and 30, bit-equal: "
            f"{all(eq6)}); K7 rejects them (consumed 3)")
    return abs5, abs6, abs7


# ---------------------------------------------------------------------------
# the 1-D models (`ccgp_tpu/experiments/sim_1d.py`,
# `sim_1d_two_families.py`) at full width: n = 8, 50 points, f64
# ---------------------------------------------------------------------------

FAST_1D = dict(start=(0.0, 1.5, 0.0), n_max=1200, samp_size=300,
               net_samp_size=200)   # the JAX package's --fast budget
FULL_1D = dict(start=(0.0, 1.5, 0.0), n_max=10000, samp_size=5000,
               net_samp_size=2500)  # sim_1d.Config's budget
SEED_1D = 0        # the key the CLI's `sim_1d` run takes by default
# GPU against CPU on a 1-D path: the chains must take the same decisions
# (equal counters). The draws and predictions may differ further down:
# the plug-in sigma2 agrees to 2.4e-15 on an H100, but the draws of
# PRNGKey(0)'s Matern design read 2.7e-8 and 3.2e-8 (K = 4 and 1), the
# spline design's 4.4e-15. Where the difference enters after the plug-in
# is not measured (a BFGS stopping point, gradient below 1e-5, such as the
# Laplace step's, would carry it). 1e-7 is the CPU tests' limit against JAX
PATH_1D_RTOL = 1e-7


def data_1d(seed, device):
    """The 1-D studies' data for PRNGKey(seed), as `sim_1d.data_1d` makes
    it: an 8-point `random_lhs` from split(key)[0], function 1, 50
    points; (x, y, x_new, y_true, study key)."""
    from ccgp_tpu_torch.experiments import sim_1d
    from ccgp_tpu_torch.ops import rng

    return sim_1d.data_1d(sim_1d.Config(), rng.PRNGKey(seed, device=device),
                          torch.float64, torch.device(device))


def _spec_1d(name):
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.ops import kernels

    second = (kernels.matern_family(5.0) if name == "sim_1d"
              else kernels.spline_family())
    return MixtureSpec(kernels.matern_family(5.0), second, dim=1)


def fit_predict_1d(name, K, device, budget=FAST_1D, seed=SEED_1D):
    """`sim_1d` (Matern(5) x Matern(5)) or `sim_1d_two_families` (Matern(5)
    x cubic spline) as `run_study` composes their combined GP for
    PRNGKey(seed): `data_1d`'s design and data, IG(3,2) / IG(5,16) priors,
    the BFGS kriging plug-in (Matern(5)), Quant against the truth, the fit
    and predict keys of split(study key, 4). Returns (fit, pred, x_new,
    y_true)."""
    from ccgp_tpu_torch.models.combined_gp import (
        MCMCConfig, fit_combined_gp, predict_combined_gp)
    from ccgp_tpu_torch.ops import kernels, rng

    x, y, x_new, y_true, k_s = data_1d(seed, device)
    y_true = torch.tensor(y_true, dtype=torch.float64, device=device)
    spec = _spec_1d(name)
    kf, kp = rng.split(k_s, 4)[:2]
    fit = fit_combined_gp(spec, x, y, kf,
                          mcmc=MCMCConfig(**budget, speculative=K),
                          mle_family=kernels.matern_family(5.0),
                          device=device)
    pred = predict_combined_gp(spec, fit, x, x_new, kp, quant_ref=y_true,
                               device=device)
    return fit, pred, x_new, y_true


def _guards_1d(fit, pred, y_true, label):
    from ccgp_tpu_torch.infer.diagnostics import effective_sample_size

    mean = pred.mean.cpu().numpy()
    truth = y_true.cpu().numpy()
    if mean.shape != (50,) or not np.isfinite(mean).all():
        raise AssertionError(f"{label}: non-finite or misshapen predictions")
    rmspe = float(np.sqrt(np.mean((truth - mean) ** 2)))
    lo, hi = pred.lower.cpu().numpy(), pred.upper.cpu().numpy()
    cover = float(np.mean((truth >= lo) & (truth <= hi)))
    ess = float(torch.min(effective_sample_size(fit.zs[None].cpu())))
    if not fit.chain_ok:
        raise AssertionError(f"{label}: chain unhealthy "
                             f"(n_recorded={fit.mcmc.n_recorded})")
    if not rmspe < 0.3:
        raise AssertionError(f"{label}: rmspe {rmspe} >= 0.3")
    if not cover >= 0.80:
        raise AssertionError(f"{label}: coverage {cover} < 0.80")
    return rmspe, cover, ess


CASES_1D = (("sim_1d", 4), ("sim_1d_two_families", 4), ("sim_1d", 0))


def _fits_1d_cpu(queue) -> None:
    """Phase 12's CPU sides, one after another, in a child process (spawn):
    each case's chain counters, draws, sigma^2, predictions and host ms,
    as numpy, put on `queue` (or the error's traceback). The child leaves
    two cores to the parent, whose card fits are host-bound."""
    import os
    import traceback

    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 4) - 2))
        out = {}
        for name, K in CASES_1D:
            t0 = time.perf_counter()
            fc, pc, _, _ = fit_predict_1d(name, K, "cpu")
            m = fc.mcmc
            out[(name, K)] = {
                "chain": (m.n_recorded, m.n_proposals, m.n_rounds,
                          m.converged),
                "zs": fc.zs.numpy(), "sigma2": fc.sigma2.numpy(),
                **{a: getattr(pc, a).numpy()
                   for a in ("mean", "lower", "upper")},
                "ms": (time.perf_counter() - t0) * 1e3}
        queue.put(out)
    except Exception:   # the parent raises with it
        queue.put(traceback.format_exc())


def phase_1d():
    """The 1-D models on the card, each against the same fit on the CPU;
    the CPU fits run in a child process beside the card's."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    child = ctx.Process(target=_fits_1d_cpu, args=(queue,))
    child.start()
    gpu = {}
    try:
        for name, K in CASES_1D:
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fg, pg, _, y_true = fit_predict_1d(name, K, "cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            gpu[(name, K)] = (fg, pg, y_true, ms, _read_counts())
        cpu = queue.get(timeout=1800)   # drained before the join
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.kill()
            child.join()
    if isinstance(cpu, str):
        raise AssertionError(f"phase 12's CPU fits failed:\n{cpu}")
    paths = {}
    for name, K in CASES_1D:
        label = f"{name} K={K or 1}"
        fg, pg, y_true, ms, launches = gpu[(name, K)]
        c = cpu[(name, K)]
        mg = fg.mcmc
        chain = (mg.n_recorded, mg.n_proposals, mg.n_rounds, mg.converged)
        for a, g, v in zip(("n_recorded", "n_proposals", "n_rounds",
                            "converged"), chain, c["chain"]):
            if g != v:
                raise AssertionError(f"{label}: {a} differs GPU vs CPU")
        t = torch.from_numpy
        err_z = _rel_err(fg.zs, t(c["zs"]))
        err_p = max(_rel_err(getattr(pg, a), t(c[a]))
                    for a in ("mean", "lower", "upper"))
        err_s2 = _rel_err(fg.sigma2, t(c["sigma2"]))
        if not (err_z <= PATH_1D_RTOL and err_p <= PATH_1D_RTOL):
            raise AssertionError(f"{label}: GPU vs CPU draws {err_z:.3g}, "
                                 f"predictions {err_p:.3g} > {PATH_1D_RTOL:g}")
        rmspe, cover, ess = _guards_1d(fg, pg, y_true, label)
        log(f"[12] {label}: n_recorded={mg.n_recorded} n_proposals="
            f"{mg.n_proposals} n_rounds={mg.n_rounds} chain_ok="
            f"{fg.chain_ok} sigma2={float(fg.sigma2):.8g} rmspe={rmspe:.5f} "
            f"coverage95={cover:.3f} min_ess={ess:.1f}; GPU == CPU (the same "
            f"decisions; sigma2 {err_s2:.3g}, draws {err_z:.3g}, predictions "
            f"{err_p:.3g}, tol {PATH_1D_RTOL:g}); fit+predict {ms:.1f} "
            f"ms on the GPU ({1e3 * ms / mg.n_rounds:.1f} us/round), "
            f"{c['ms']:.1f} ms on the CPU (host clock, in the child process "
            f"beside the card's fits); launches={launches}")
        if K > 1 and launches["chol_quadratics_smallk"] != mg.n_rounds:
            raise AssertionError(f"{label}: K5 must launch once per round")
        if launches["chunk_draws"] != mg.n_rounds:
            raise AssertionError(f"{label}: chunk_draws must launch once per "
                                 f"round")
        _require_launched(launches, ("chol_factors_lanes",), label)
        paths[label] = launches
    return paths


def phase_sim1d_full():
    """`sim_1d` as the experiment runs it (K = 1) at its own budget
    (n_max 10000, samp 5000, net 2500), on the GPU only. Not a phase of
    the smoke run (tens of minutes); run it alone with
    python3 -c 'import chip_smoke as s; s.phase_device(); s.phase_build();
    s.phase_sim1d_full()'."""
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, pred, _, y_true = fit_predict_1d("sim_1d", 0, "cuda",
                                          budget=FULL_1D)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _read_counts()
    rmspe, cover, ess = _guards_1d(fit, pred, y_true, "sim_1d full")
    mc = fit.mcmc
    log(f"[sim_1d full budget] K=1: n_recorded={mc.n_recorded} "
        f"n_proposals={mc.n_proposals} n_rounds={mc.n_rounds} chain_ok="
        f"{fit.chain_ok} sigma2={float(fit.sigma2):.8g} rmspe={rmspe:.5f} "
        f"coverage95={cover:.3f} min_ess={ess:.1f}; fit+predict {ms:.1f} "
        f"ms ({1e3 * ms / mc.n_rounds:.1f} us/round); launches={launches}")
    _require_launched(launches, ("chol_factors_lanes",), "sim_1d full")


K1_BLOCK_SIZES = (256, 512, 1024)


def _variant(path, names):
    """A sweep's build of one source, loaded with the package's C
    signatures for its entry points `names`."""
    import ctypes

    from ccgp_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _build_variants(source, defines):
    """One build of csrc/<source> per entry of `defines` (a label -> nvcc
    -D flags), all in parallel, into _build/sweep/. Returns label -> path."""
    from ccgp_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    src = str(_build.SRC_DIR / source)
    outs = {label: _build.BUILD_DIR / "sweep" / f"{source}.{label}.so"
            for label in defines}
    next(iter(outs.values())).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o",
                      str(outs[label]), src]
                     for label, flags in defines.items()])
    log(f"[sweep] {len(outs)} builds of {source} in "
        f"{time.perf_counter() - t0:.1f} s")
    return outs


def ptxas_report():
    """Not a phase: each kernel's registers and spills as ptxas reports
    them, every csrc/*.cu compiled once more with the package's flags and
    -Xptxas -v (all in parallel, objects thrown away), the names demangled
    with c++filt. Run it alone with python3 -c 'import chip_smoke as s;
    s.phase_device(); s.ptxas_report()'."""
    import re
    import tempfile

    from ccgp_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        srcs = sorted(_build.SRC_DIR.glob("*.cu"))
        procs = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             f"{tmp}/{src.stem}.o", str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for src in srcs]
        reports = [p.communicate()[0] for p in procs]
    for src, proc, text in zip(srcs, procs, reports):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed on {src.name}:\n"
                               f"{text}")
        name, frame = None, ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = subprocess.run(["c++filt", m.group(1)],
                                      capture_output=True, text=True,
                                      check=True).stdout.strip()
            m = re.search(r"\d+ bytes stack frame.*", line)
            if m:
                frame = m.group(0)
            m = re.search(r"Used \d+ registers", line)
            if m and name:
                name = name.replace("(anonymous namespace)::", "")
                log(f"[ptxas] {src.name}: "
                    f"{name.removeprefix('void ').split('(')[0]}: "
                    f"{m.group(0)}, {frame}")
                name, frame = None, ""


def k1_block_sizes():
    """Not a phase: K1's single-tile core at each block size of
    K1_BLOCK_SIZES that holds its tiles, CUDA events per call (R = 120,
    stash), on the bench shape in f32 and f64, the study's n = 14 in f64
    and K = 16 (two candidates per block) in f32. Each size is its own
    build of `csrc/mh_rounds.cu` with -DCCGP_K1_THREADS=<size> (all built
    in parallel), routed to through `_build.library`; its records must equal
    the package build's bit for bit. The sweep behind `reg_threads` in
    `csrc/mh_rounds.cu`; run it alone with python3 -c 'import chip_smoke
    as s; s.phase_device(); s.phase_build(); s.k1_block_sizes()'."""
    from ccgp_tpu_torch.ops import _build, chol_smallk

    outs = _build_variants("mh_rounds.cu", {
        nt: [f"-DCCGP_K1_THREADS={nt}"] for nt in K1_BLOCK_SIZES})
    variants = {nt: _variant(out, ("ccgp_mh_rounds_f32", "ccgp_mh_rounds_f64",
                                   "ccgp_mh_rounds_layout"))
                for nt, out in outs.items()}
    package = _build.library
    try:
        for n, kk, dtype, jit in ((100, 4, torch.float32, 1e-3),
                                  (100, 4, torch.float64, 1e-6),
                                  (14, 4, torch.float64, 1e-8),
                                  (100, 16, torch.float32, 1e-3)):
            args = _rounds_case(n, 120, dtype, jit, seed=n, kk=kk)
            _build.library = package
            ref = chol_smallk.fused_mix_mh_rounds(**args)
            times = []
            for nt, variant in variants.items():
                _build.library = lambda: variant  # noqa: E731
                try:
                    got = chol_smallk.fused_mix_mh_rounds(**args)
                except RuntimeError as e:   # fewer threads than tiles
                    times.append(f"{nt} threads refused ({e})")
                    continue
                if not (torch.equal(got["rec"], ref["rec"])
                        and torch.equal(got["stash"].nan_to_num(),
                                        ref["stash"].nan_to_num())):
                    raise AssertionError(f"K1 at {nt} threads moved a bit")
                ms = _cuda_ms(lambda: chol_smallk.fused_mix_mh_rounds(
                    **args), 5)
                times.append(f"{nt} threads {ms:.3f} ms "
                             f"({1e3 * ms / 120:.1f} us/round)")
            log(f"[k1 sweep] fused_mix_mh_rounds n={n} K={kk} R=120 "
                f"{dtype} (CUDA events per call): " + ", ".join(times))
    finally:
        _build.library = package


# (cluster blocks C, rows per panel b) of K5's panel core
K5_PANEL_SIZES = ((4, 8), (8, 4), (8, 8), (16, 4), (16, 8))


def k5_panel_sizes():
    """Not a phase: K5's panel core (n > 128) at each (cluster blocks C,
    rows per panel b) of K5_PANEL_SIZES, CUDA events per call, at K = 4 and
    n in {256, 512, 1024} in f32, n = 512 in f64, and K = 16, n = 512 in
    f32 (16 clusters). Each size is its own
    build of `csrc/chol_smallk.cu` with -DCCGP_K5_PANEL_C=<C>
    -DCCGP_K5_PANEL_B=<b> (all built in parallel), routed to through
    `_build.library`; its quadratics must equal the package build's bit for
    bit. The sweep behind `layout` in `csrc/chol_smallk.cu`; run it alone
    with python3 -c 'import chip_smoke as s; s.phase_device();
    s.phase_build(); s.k5_panel_sizes()'."""
    from ccgp_tpu_torch.ops import _build, chol_smallk

    outs = _build_variants("chol_smallk.cu", {
        f"C{c}b{b}": [f"-DCCGP_K5_PANEL_C={c}", f"-DCCGP_K5_PANEL_B={b}"]
        for c, b in K5_PANEL_SIZES})
    variants = {label: _variant(out, ("ccgp_chol_quad_smallk_f32",
                                      "ccgp_chol_quad_smallk_f64",
                                      "ccgp_smallk_layout"))
                for label, out in outs.items()}
    package = _build.library
    try:
        for kk, n, dtype in ((4, 256, torch.float32),
                             (4, 512, torch.float32),
                             (4, 1024, torch.float32),
                             (4, 512, torch.float64),
                             (16, 512, torch.float32)):
            g, y = (torch.tensor(a, dtype=dtype, device="cuda")
                    for a in se_grams(kk, n, seed=n))
            fn = lambda: chol_smallk.chol_quadratics_smallk(g, y, jitter=1e-3)  # noqa: E731
            _build.library = package
            ref = fn()
            times = [f"package {_cuda_ms(fn, 20):.4f} ms"]
            for label, variant in variants.items():
                _build.library = lambda: variant  # noqa: E731
                try:
                    got = fn()
                    torch.cuda.synchronize()
                except RuntimeError as e:   # a cluster the card refuses
                    times.append(f"{label} refused ({e})")
                    continue
                if not all(torch.equal(got[k], ref[k]) for k in ref):
                    raise AssertionError(f"K5 at {label} moved a bit")
                times.append(f"{label} {_cuda_ms(fn, 20):.4f} ms")
            log(f"[k5 sweep] chol_quadratics_smallk K={kk} n={n} {dtype} "
                f"(CUDA events per call): " + ", ".join(times))
    finally:
        _build.library = package


LANES_SWEEP_N = (8, 14, 16, 24, 32)


def lanes_paths():
    """Not a phase: K3 and K4 on each of their two paths at n in
    LANES_SWEEP_N, B = 1728 in f64 (the EB row's batch, jitter 1e-6) and
    B = 128 in f32 (the MAP cloud's, 1e-3), device time under
    torch.profiler. Each path is its own build of `csrc/chol_lanes.cu`:
    -DCCGP_LANES_WARP_MAX_N=32 (the warp path for every n of the sweep)
    and =0 (the tile path for every n), built in parallel and routed to
    through `_build.library`; their outputs must equal the package build's
    bit for bit. The sweep behind WARP_MAX_N in `csrc/chol_lanes.cu`; run
    it alone with python3 -c 'import chip_smoke as s; s.phase_device();
    s.phase_build(); s.lanes_paths()'. Last, K3's tile path against K5
    on the same Grams (B = 16, n = 32 and 100, f32)."""
    from ccgp_tpu_torch.ops import _build, chol_lanes, chol_smallk

    outs = _build_variants("chol_lanes.cu", {
        "warp": ["-DCCGP_LANES_WARP_MAX_N=32"],
        "tiles": ["-DCCGP_LANES_WARP_MAX_N=0"]})
    names = ("ccgp_chol_lanes_f32", "ccgp_chol_lanes_f64",
             "ccgp_chol_lanes_layout")
    variants = {label: _variant(out, names) for label, out in outs.items()}
    package = _build.library
    try:
        for b, dtype in ((1728, torch.float64), (128, torch.float32)):
            jit = LANES_JITTER[dtype]
            for n in LANES_SWEEP_N:
                g, y = (torch.tensor(a, dtype=dtype, device="cuda")
                        for a in se_grams(b, n, seed=n))
                for kern in (chol_lanes.chol_quadratics_lanes,
                             chol_lanes.chol_factors_lanes):
                    fn = lambda: kern(g, y, jitter=jit)  # noqa: E731
                    _build.library = package
                    ref = fn()
                    times = []
                    for label, variant in variants.items():
                        _build.library = lambda: variant  # noqa: E731
                        if not _lanes_equal(fn(), ref):
                            raise AssertionError(f"{kern.__name__} on the "
                                                 f"{label} path moved a bit")
                        k, how = _kernel_ms(kern.__name__, fn, 20,
                                            _cuda_ms(fn, 20))
                        times.append(f"{label} {k:.4f} ms {how}")
                    log(f"[lanes sweep] {kern.__name__} B={b} n={n} {dtype}: "
                        + ", ".join(times))
        # the tile path's pivot policy against K5's, on the same core and
        # the same Grams (B = K = 16, the most K5 takes; f32): what the
        # lanes order of arithmetic (a square root and divisions per pivot,
        # where K5 has rsqrt and products) costs
        for n in (32, 100):
            g, y = (torch.tensor(a, dtype=torch.float32, device="cuda")
                    for a in se_grams(16, n, seed=n))
            _build.library = lambda: variants["tiles"]  # noqa: E731
            fn = lambda: chol_lanes.chol_quadratics_lanes(g, y, jitter=1e-3)  # noqa: E731
            k3, how3 = _kernel_ms("chol_quadratics_lanes", fn, 20,
                                  _cuda_ms(fn, 20))
            _build.library = package
            fn = lambda: chol_smallk.chol_quadratics_smallk(g, y, jitter=1e-3)  # noqa: E731
            k5, how5 = _kernel_ms("chol_quadratics_smallk", fn, 20,
                                  _cuda_ms(fn, 20))
            log(f"[lanes sweep] B=16 n={n} f32, the same Grams on the "
                f"register-tile core: K3's tile path {k3:.4f} ms {how3}, "
                f"K5 {k5:.4f} ms {how5}")
    finally:
        _build.library = package


def _sole_kernel_ms(fn, reps):
    """(ms, name) of the one kernel each call of fn launches: its device
    time per call under torch.profiler, from a window that recorded it
    `reps` times (one retry); (nan, what was seen) otherwise."""
    for _ in range(2):
        by_name, _ = _device_profile(fn, reps)
        if len(by_name) == 1:
            name, (ms, seen) = next(iter(by_name.items()))
            if seen == reps:
                return ms, name
    return math.nan, f"records lost: {by_name}"


def _k9_cases():
    """(label, Grams, y, jitter) of K9's timings: the MAP cloud (B = 128,
    n = 100, f32, jitter 1e-3) and B = 128 SE Grams at n = 128 in f64
    (jitter 1e-6, the most shared memory)."""
    mp, map_grams = map_cloud_inputs()
    g, y = (torch.tensor(a, dtype=torch.float64, device="cuda")
            for a in se_grams(128, 128, seed=128))
    return [("map_cloud B=128 n=100 f32", map_grams(), mp["y"], 1e-3),
            ("B=128 n=128 f64", g, y, 1e-6)]


K9_BLOCK_SIZES = (256, 512, 1024)


def k9_block_sizes():
    """Not a phase: K9 at each block size of K9_BLOCK_SIZES (a build of
    `csrc/chol_nll.cu` with -DCCGP_K9_THREADS=<size> each, built in
    parallel and routed to through `_build.library`) at `_k9_cases`'
    shapes, device time under torch.profiler; each build's outputs must
    equal the package build's bit for bit. The sweep behind NLL_THREADS in
    `csrc/chol_nll.cu`; run it alone with python3 -c 'import chip_smoke as
    s; s.phase_device(); s.phase_build(); s.k9_block_sizes()'."""
    from ccgp_tpu_torch.ops import _build, chol_nll

    outs = _build_variants("chol_nll.cu", {
        f"{t} threads": [f"-DCCGP_K9_THREADS={t}"] for t in K9_BLOCK_SIZES})
    variants = {label: _variant(out, ("ccgp_chol_nll_f32",
                                      "ccgp_chol_nll_f64"))
                for label, out in outs.items()}
    package = _build.library
    try:
        for label, g, y, jit in _k9_cases():
            fn = lambda: chol_nll.chol_nll(g, y, jitter=jit)  # noqa: E731
            _build.library = package
            ref = fn()
            times = []
            for size, variant in variants.items():
                _build.library = lambda: variant  # noqa: E731
                if not _lanes_equal(fn(), ref):
                    raise AssertionError(f"K9 at {size} moved a bit")
                k, how = _kernel_ms("chol_nll", fn, 20, _cuda_ms(fn, 20))
                times.append(f"{size} {k:.4f} ms {how}")
            log(f"[k9 sweep] chol_nll {label}: " + ", ".join(times))
    finally:
        _build.library = package


def k9_clock_split():
    """Not a phase: where K9's time goes, from a build of `csrc/chol_nll.cu`
    with -DCCGP_K9_CLOCKS, whose block 0 records clock64 spans: the load,
    the first top block, the steps' span, and the busy cycles of warp 0
    (the pivots' chain: the next top rows, the next top block's sums and
    its factorization), warp 1 (the partial sums), warp 2 (the solve: its
    downdate, the in-panel recursion, the running sums) and the first row
    warp, each summed over the steps; at `_k9_cases`' shapes, the outputs bit-equal to the package build's. Run it alone
    with python3 -c 'import chip_smoke as s; s.phase_device();
    s.phase_build(); s.k9_clock_split()'."""
    import ctypes

    from ccgp_tpu_torch.ops import _build, chol_nll

    out = _build_variants("chol_nll.cu", {"clocks": ["-DCCGP_K9_CLOCKS"]})
    lib = _variant(out["clocks"], ("ccgp_chol_nll_f32", "ccgp_chol_nll_f64"))
    lib.ccgp_k9_clocks.argtypes = [ctypes.c_void_p]
    mhz, _ = _sm_clock_mhz()
    package = _build.library
    try:
        for label, g, y, jit in _k9_cases():
            _build.library = package
            ref = chol_nll.chol_nll(g, y, jitter=jit)
            _build.library = lambda: lib  # noqa: E731
            got = chol_nll.chol_nll(g, y, jitter=jit)
            torch.cuda.synchronize()
            if not _lanes_equal(got, ref):
                raise AssertionError("the clocks build moved a bit")
            buf = (ctypes.c_longlong * 15)()
            _build.check(lib.ccgp_k9_clocks(ctypes.addressof(buf)),
                         "k9_clocks")
            us = [v / mhz for v in buf]
            log(f"[k9 clocks] {label}, block 0, us at {mhz:g} MHz: load "
                f"{us[0]:.2f}, first top block {us[1]:.2f}, steps "
                f"{us[2]:.2f}; busy in the steps: warp 0 (pivots) next top "
                f"rows {us[3]:.2f}, next top block's sums {us[4]:.2f}, its "
                f"factorization {us[5]:.2f}; warp 1 (partial sums) "
                f"{us[6]:.2f}; warp 2 (solve) downdate {us[9]:.2f}, "
                f"in-panel {us[10]:.2f}, running sums {us[11]:.2f}; first "
                f"row warp {us[12]:.2f}")
    finally:
        _build.library = package


def _compare_turns(source, names, other, cases):
    """Each case's kernel with the package build and with a build of the
    `source` at the path `other` (another commit's, with the same C entry
    points `names`), in turns other, package, package, other in one
    process: device ms per call under torch.profiler, and whether the two
    builds' outputs are equal bit for bit. cases: (label, fn)."""
    from ccgp_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "sweep" / f"{source}.other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(out), str(other)]])
    builds = {"other": _variant(out, names), "package": _build.library()}
    package = _build.library
    try:
        for label, fn in cases:
            outs, times, knames = {}, [], {}
            for turn in ("other", "package", "package", "other"):
                _build.library = lambda: builds[turn]  # noqa: E731
                outs[turn] = fn()
                ms, knames[turn] = _sole_kernel_ms(fn, 20)
                times.append(f"{turn} {ms:.4f}")
            log(f"[compare] {label}: device ms per call {' / '.join(times)}; "
                f"outputs equal: {_lanes_equal(outs['other'], outs['package'])}"
                f"; kernels {knames['package'][:60]} / "
                f"{knames['other'][:60]}")
    finally:
        _build.library = package


def compare_builds(other):
    """Not a phase: K3/K4 at phase 6's shapes (`_lanes_inputs`, from a fit
    of the bench workload) and K9 at `_k9_cases`' shapes, each with the
    package build and with the build of the same source in the tree at
    `other` (another commit's checkout), by `_compare_turns`. Run it with
    python3 -c 'import chip_smoke as s; s.phase_device(); s.phase_build();
    s.compare_builds("<other tree>")' (unpack the other commit with `git
    archive` into `chip_check/`, which `.gitignore` lists)."""
    from pathlib import Path

    from ccgp_tpu_torch.ops import chol_lanes, chol_nll

    csrc = Path(other) / "ccgp_tpu_torch" / "csrc"
    x, y, grid = bench_data()
    fit, _ = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                          **BENCH_CFG)
    grams, ys, jit = _lanes_inputs(fit)
    cases = []
    for name, factors in LANES_TIMED:
        kern = (chol_lanes.chol_factors_lanes if factors
                else chol_lanes.chol_quadratics_lanes)
        g, yy, j = grams[name], ys[name], jit[name]
        cases.append((f"{kern.__name__} {name} B={g.shape[0]} "
                      f"n={g.shape[-1]} {g.dtype}",
                      lambda kern=kern, g=g, yy=yy, j=j: kern(g, yy, jitter=j)))
    _compare_turns("chol_lanes.cu", ("ccgp_chol_lanes_f32",
                                     "ccgp_chol_lanes_f64"),
                   csrc / "chol_lanes.cu", cases)
    _compare_turns("chol_nll.cu", ("ccgp_chol_nll_f32", "ccgp_chol_nll_f64"),
                   csrc / "chol_nll.cu",
                   [(f"chol_nll {label}",
                     lambda g=g, y=y, j=j: chol_nll.chol_nll(g, y, jitter=j))
                    for label, g, y, j in _k9_cases()])


def e2e_times(tag, phases=("5", "13", "12")):
    """Not a phase: the end-to-end times of the full-Bayes path (phase 5's
    workload, FULL_BAYES_CALLS calls after one to warm up, CUDA events),
    the one-round SE route (phase 13's, host clock) and both 1-D models at
    K = 4 (phase 12's, host clock), each with its chain, through the
    package that `import ccgp_tpu_torch` finds: no launch counter is read,
    so another commit's package can be timed by this function. Run a
    checkout's package with this file from its root: python3 -c 'import
    importlib.util as u; s = u.spec_from_file_location("cs",
    "<this file>"); m = u.module_from_spec(s); s.loader.exec_module(m);
    m.phase_device(); m.e2e_times("<tag>")'."""
    from ccgp_tpu_torch.models import combined_gp

    x, y, grid = bench_data()
    if "5" in phases:
        _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3, **BENCH_CFG)
        times = []
        for _ in range(FULL_BAYES_CALLS):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            ev0.record()
            fit, _ = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                                  **BENCH_CFG)
            ev1.record()
            torch.cuda.synchronize()
            times.append(ev0.elapsed_time(ev1))
        mc = fit.mcmc
        log(f"[e2e {tag}] full-Bayes: median {float(np.median(times)):.1f} "
            f"ms (each: {', '.join(f'{t:.1f}' for t in times)}); chain "
            f"{mc.n_recorded} / {mc.n_proposals} / {mc.n_rounds}")
    if "13" in phases:
        combined_gp.MH_ROUNDS_CHUNKING = False
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit, _ = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                                  **BENCH_CFG)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            combined_gp.MH_ROUNDS_CHUNKING = True
        mc = fit.mcmc
        log(f"[e2e {tag}] one-round SE: {ms:.1f} ms ({1e3 * ms / mc.n_rounds:.1f}"
            f" us/round); chain {mc.n_recorded} / {mc.n_proposals} / "
            f"{mc.n_rounds}")
    if "12" in phases:
        for name in ("sim_1d", "sim_1d_two_families"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit, _, _, _ = fit_predict_1d(name, 4, "cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            mc = fit.mcmc
            log(f"[e2e {tag}] {name} K=4: {ms:.1f} ms ({ms / mc.n_rounds:.2f}"
                f" ms/round); chain {mc.n_recorded} / {mc.n_proposals} / "
                f"{mc.n_rounds}")


# ---------------------------------------------------------------------------
# the one-round SE routes: the fused round kernel K7 and the fused
# quadratics kernel K6
# ---------------------------------------------------------------------------

def phase_one_round():
    from ccgp_tpu_torch.infer.metropolis import metropolis
    from ccgp_tpu_torch.models import combined_gp
    from ccgp_tpu_torch.models.likelihood import (
        make_logpost, make_logpost_batch, make_mh_round, make_mh_rounds)
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import rng

    paths = {}
    x, y, grid = bench_data()
    combined_gp.MH_ROUNDS_CHUNKING = False
    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit, pred = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                                 **BENCH_CFG)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
    finally:
        combined_gp.MH_ROUNDS_CHUNKING = True
    mc = fit.mcmc
    mean = pred.mean.double().cpu().numpy()
    lo, hi = (pred.lower.double().cpu().numpy(),
              pred.upper.double().cpu().numpy())
    if mean.shape != (625,) or not np.isfinite(mean).all():
        raise AssertionError("one-round path: non-finite predictions")
    y_true = f2(grid)
    rmspe = float(np.sqrt(np.mean((y_true - mean) ** 2)))
    cover = float(np.mean((y_true >= lo) & (y_true <= hi)))
    log(f"[13] bench workload, one-round route (MH_ROUNDS_CHUNKING = "
        f"False): n_recorded={mc.n_recorded} n_proposals={mc.n_proposals} "
        f"n_rounds={mc.n_rounds} chain_ok={fit.chain_ok} rmspe={rmspe:.5f} "
        f"coverage95={cover:.3f}; fit+predict {ms:.1f} ms (host clock), "
        f"{1e3 * ms / mc.n_rounds:.1f} us/round; launches={launches}")
    if not (rmspe < 0.03 and cover >= 0.80 and fit.chain_ok):
        raise AssertionError("one-round path: phase 5's guards not met")
    if launches["fused_mix_mh_round"] != mc.n_rounds:
        raise AssertionError("K7 must launch once per round")
    if launches["chunk_draws"] != mc.n_rounds:
        raise AssertionError("chunk_draws must launch once per round")
    paths["one-round bench"] = launches

    # small f64: the chunked (K1), body_mh (K7) and body_spec (K6) chains
    xs = np.random.default_rng(0).uniform(size=(20, 2))
    ys = np.sin(5 * xs[:, 0]) + np.cos(3 * xs[:, 1])
    t = lambda a: torch.tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    args = (_spec(), t(xs), t(ys), t(0.05))
    pri = dict(theta1_prior=LogNormal(-1.0, 1.0),
               theta2_prior=InverseGamma(3, 4), jitter=1e-6)
    logpost = make_logpost(*args, **pri)
    from ccgp_tpu_torch.infer.laplace import laplace

    fit0 = laplace(lambda z: logpost(z).val, t([1.0, 1.0, 0.0, 0.0]))
    run = dict(n_max=400, samp_size=120, speculative=4, laplace_fit=fit0)
    key = rng.PRNGKey(1, device="cuda")
    chains = {}
    for route, kw in (("chunked", dict(mh_rounds=make_mh_rounds(*args,
                                                                **pri))),
                      ("body_mh", dict(mh_round=make_mh_round(*args, **pri))),
                      ("body_spec", dict(logpost_batch=make_logpost_batch(
                          *args, **pri)))):
        _zero_counts()
        chains[route] = metropolis(logpost, fit0.mode, key, **run, **kw)
        paths[f"small f64 {route}"] = _read_counts()
    ref = chains["chunked"]
    for route in ("body_mh", "body_spec"):
        c = chains[route]
        for a in ("n_recorded", "n_proposals", "n_rounds", "converged"):
            if getattr(c, a) != getattr(ref, a):
                raise AssertionError(f"small f64: {route} {a} differs from "
                                     f"the chunked chain")
        k = ref.n_recorded
        err = _rel_err(c.samples[:k], ref.samples[:k])
        if not err <= 1e-8:
            raise AssertionError(f"small f64: {route} draws {err:.3g}")
    for route, kern in (("chunked", "fused_mix_mh_rounds"),
                        ("body_mh", "fused_mix_mh_round"),
                        ("body_spec", "fused_mix_quadratics_smallk")):
        _require_launched(paths[f"small f64 {route}"], (kern,),
                          f"small f64 {route}")
    log(f"[13] small f64 (n=20, K=4): the chunked (K1), body_mh (K7) and "
        f"body_spec (K6) chains agree: n_recorded={ref.n_recorded} "
        f"n_proposals={ref.n_proposals} n_rounds={ref.n_rounds}, draws "
        f"within 1e-8")
    return paths


# ---------------------------------------------------------------------------
# K9 (the per-matrix left-looking kernel behind chol_quadratics(use_pallas=
# True)) and K8 (the fused mixture-Gram kernel fused_mix_quadratics)
# ---------------------------------------------------------------------------

# f32 against an f64 oracle on the MAP cloud's Grams (unit diagonal,
# jitter 1e-3, n = 100: condition numbers up to ~1e5, f32 roundoff 6e-8,
# so up to ~6e-3 in the worst case): 2e-3 relative to max(1, |value|).
# K3, the route real callers take, is logged beside it: its right-looking
# downdates round less than K9's left-looking dot products
ORACLE_F32_RTOL = 2e-3
# K8 on an EB row against the materialized covariance through K3. Each
# covariance is s2t R + 1e4 J: the 1e4 swamps the last digits of s2t R,
# and R's condition number amplifies the two factorizations' different
# rounding (rsqrt-scaled against sqrt-divided pivots). Per node (rows 0
# and EB_ROW), relative to the row's largest value: the CPU twins read
# logdet 7.5e-8 and qyy 2.6e-6 on row 0, 2.0e-10 and 6.1e-9 on row 24.
# The row's log marginal likelihood (the number the scan compares), held
# on the row phase 9 chooses: the CPU twins agree to 7e-12 there; on row 0
# only to 4.5e-10 (1.5e-9 on the card), on row 30 to 2e-8
EB_NODE_RTOL = {"logdet": 1e-6, "qyy": 1e-5}
EB_ROW_RTOL = 1e-9


def k8_case(b, n, d, dtype, seed, per_lane):
    """K8 inputs: mix_case's x, y, rates and weights for b lanes, with
    scale and shift per lane (uniform on (0.5, 2) and (0, 3)) or scalars."""
    args, _ = mix_case(b, n, d, dtype, seed)
    if per_lane:
        r = np.random.default_rng(seed + 1)
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        args.update(scale=t(r.uniform(0.5, 2.0, b)),
                    shift=t(r.uniform(0.0, 3.0, b)))
    else:
        args.update(scale=1.3, shift=0.2)
    return args


# K9's shapes in phase 14: one panel (n = 1, 8), a last panel of one
# column (9, 17), of six (14) and of seven (127), one row below the top
# rows (17), the MAP cloud's n and the limit
K9_N = (1, 8, 9, 14, 17, 33, 100, 127, 128)


def phase_k8_k9():
    """K9 and K8 against their plain twins on every listed shape, NaN
    batches, the upper triangle, the limits."""
    from ccgp_tpu_torch.ops import chol_nll, gram_chol

    t0 = time.perf_counter()
    abs8 = abs9 = 0.0
    for dtype, jitter in ((torch.float32, 1e-3), (torch.float64, 1e-6)):
        tol = F32_RTOL if dtype == torch.float32 else F64_RTOL
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        errs, nbit = [], 0
        for b in (1, 4, 32, 128):
            for n in K9_N:
                g, y = (t(a) for a in se_grams(b, n, seed=b + n))
                got = chol_nll.chol_nll(g, y, jitter=jitter)
                ref = chol_nll.chol_nll_plain(g, y, jitter=jitter)
                torch.cuda.synchronize()
                e, ae, eq = _compare_quads(got, ref, tol,
                                           f"K9 B={b} n={n} {dtype}")
                errs.append(e)
                abs9 = max(abs9, ae)
                nbit += eq
                if not eq:
                    raise AssertionError(f"K9 B={b} n={n} {dtype}: not "
                                         f"bit-equal to the plain version "
                                         f"(rel err {e:.3g})")
        g, y = (t(a) for a in se_grams(128, 100, seed=5))
        iu = torch.triu_indices(100, 100, 1, device="cuda")
        junk = g.clone()
        junk[:, iu[0], iu[1]] = math.nan
        a = chol_nll.chol_nll(g, y, jitter=jitter)
        b_ = chol_nll.chol_nll(junk, y, jitter=jitter)
        if not all(torch.equal(a[k], b_[k]) for k in a):
            raise AssertionError("K9: the upper triangle changed an output")
        g, y = (t(a) for a in indefinite_batch())
        got = chol_nll.chol_nll(g, y)
        _, ae, eq = _compare_quads(got, chol_nll.chol_nll_plain(g, y), tol,
                                   f"K9 indefinite {dtype}")
        abs9 = max(abs9, ae)
        if not eq:
            raise AssertionError(f"K9 indefinite {dtype}: not bit-equal")
        if not torch.equal(~torch.isfinite(got["logdet"]).cpu(),
                           torch.arange(16) % 2 == 1):
            raise AssertionError("K9: NaN on the wrong members")
        log(f"[14] K9 chol_nll == plain bit for bit: {nbit} of {len(errs)} "
            f"records (B in {{1,4,32,128}} x n in {K9_N}), {dtype}; NaN "
            f"above the diagonal changes no output; an indefinite batch is "
            f"NaN on its 8 odd members in kernel and twin, bit-equal")

        errs, nbit, seen = [], 0, 0
        for b in (1, 5, 128, 1728):
            for n in (14, 26, 100, 128):
                for d in (1, 2, 9, 16):
                    for per_lane in (False, True):
                        args = k8_case(b, n, d, dtype, b + n + d, per_lane)
                        for jit in (0.0, 1e-8):
                            got = gram_chol.fused_mix_quadratics(
                                **args, jitter=jit)
                            ref = gram_chol.fused_mix_quadratics_plain(
                                **args, jitter=jit)
                            torch.cuda.synchronize()
                            e, ae, eq = _compare_quads(
                                got, ref, tol, f"K8 B={b} n={n} d={d} "
                                f"per_lane={per_lane} jitter={jit:g} {dtype}")
                            errs.append(e)
                            abs8 = max(abs8, ae)
                            nbit += eq
                            seen += int((~torch.isfinite(got["logdet"]))
                                        .sum())
        args, _ = mix_case(8, 30, 2, dtype, seed=9, indefinite=True)
        got = gram_chol.fused_mix_quadratics(**args, scale=2.0, jitter=1e-2)
        _, _, eq = _compare_quads(got, gram_chol.fused_mix_quadratics_plain(
            **args, scale=2.0, jitter=1e-2), tol, f"K8 indefinite {dtype}")
        if not torch.equal(~torch.isfinite(got["logdet"]).cpu(),
                           torch.arange(8) % 2 == 1):
            raise AssertionError("K8: NaN on the wrong lanes")
        log(f"[14] K8 fused_mix_quadratics == plain for B in "
            f"{{1,5,128,1728}} x n in {{14,26,100,128}} x d in {{1,2,9,16}} "
            f"x scale/shift scalar and per lane x jitter {{0, 1e-8}}, "
            f"{dtype}: max rel err {max(errs):.3g} (tol {tol:g}); "
            f"bit-equal: {nbit} of {len(errs)}; {seen} NaN lanes (singular "
            f"Grams at jitter "
            f"0), the same in kernel and twin; an indefinite batch is NaN "
            f"on its 4 odd lanes (bit-equal: {eq})")
    g = torch.eye(129, dtype=torch.float64, device="cuda")[None]
    for what, call in (
            ("K9 n=129", lambda: chol_nll.chol_nll(g, g[0, 0])),
            ("K8 n=129", lambda: gram_chol.fused_mix_quadratics(
                **k8_case(2, 129, 2, torch.float64, 1, True))),
            ("K8 d=17", lambda: gram_chol.fused_mix_quadratics(
                **k8_case(2, 20, 17, torch.float64, 1, True)))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{what} did not raise")
    log(f"[14] n = 129 (K8, K9) and d = 17 (K8) raise ValueError; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return abs8, abs9


def _oracle_quads(cov, y):
    """{logdet, qyy, qoy, qoo} in f64 by cholesky_ex + solve_triangular (an
    oracle for the checks only; the port never calls it)."""
    cov, y = cov.double(), y.double()
    chol, _ = torch.linalg.cholesky_ex(cov)
    rhs = torch.stack([y, torch.ones_like(y)], -1).expand(cov.shape[0], -1,
                                                          -1)
    w = torch.linalg.solve_triangular(chol, rhs, upper=False)
    wy, wo = w[..., 0], w[..., 1]
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                         dim=-1)
    return {"logdet": ld, "qyy": torch.sum(wy * wy, -1),
            "qoy": torch.sum(wy * wo, -1), "qoo": torch.sum(wo * wo, -1)}


def _max_rel(got, ref) -> float:
    return max(_rel_err(got[k], ref[k]) for k in ref)


EB_ROW = 24   # the row phase 9's scan chooses, (3, 16, 3, 256)


def eb_row_inputs(row=EB_ROW, device="cuda"):
    """One EB row (`marginal_likelihood` at `row` of `eb_grid`): n = 14,
    the 1728 Halton nodes, tau = 100, f64. Returns K8's arguments (x, y,
    r1, r2, p, scale = sigma2_t, shift = tau^2) and a function that builds
    the covariance the scan materializes, s2t R_mix + tau^2
    (`eb/hyperpriors.py`), from the device tensors."""
    from ccgp_tpu_torch.eb import halton
    from ccgp_tpu_torch.models.combination import (
        MixParams, MixtureSpec, mixed_gram)
    from ccgp_tpu_torch.ops import kernels
    from ccgp_tpu_torch.ops.special import invgamma_quantile

    xe = np.random.default_rng(0).uniform(size=(14, 2))
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    a1, b1, a2, b2 = eb_grid()[row]
    p = t(halton(1728, 1)[:, 0])
    params = MixParams(p=p, theta1=invgamma_quantile(p, a1, b1),
                       theta2=invgamma_quantile(p, a2, b2))
    iso = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    s2t = 0.01 * (p * p + (1.0 - p) ** 2)
    x = t(xe)
    cov = lambda: s2t[:, None, None] * mixed_gram(iso, x, params) + 1e4  # noqa: E731
    args = dict(x=x, y=t(f2(xe)),
                r1=params.theta1[:, None].expand(1728, 2).contiguous(),
                r2=params.theta2[:, None].expand(1728, 2).contiguous(), p=p,
                scale=s2t, shift=1e4)
    return args, cov


def map_cloud_inputs():
    """The MAP cloud (`map_fit_predict`'s 128 Halton points, n = 100, the
    tied anisotropic SE mixture, f32): K8's arguments (rates r1 = theta1
    per axis, r2 = (1 + lambda) theta1) and a function that builds the
    Grams as `mixed_gram` does."""
    from ccgp_tpu_torch.eb import halton
    from ccgp_tpu_torch.models.combination import mixed_gram, unpack

    x, y, _ = bench_data()
    t32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    params, _ = unpack(_spec(), t32(halton(128, 4) * MAP_BOX[0]
                                     + MAP_BOX[1]))
    args = dict(x=t32(x), y=t32(y), r1=params.theta1.contiguous(),
                r2=((1.0 + params.theta2)[:, None] * params.theta1),
                p=params.p)
    return args, lambda: mixed_gram(_spec(), args["x"], params)


def phase_k8_k9_paths():
    """K8 and K9 through their public entry points at the shapes of the
    calls beside them, held against the route those callers take (K3 on
    materialized covariances) and an f64 oracle."""
    from ccgp_tpu_torch.ops import fused_mix_quadratics
    from ccgp_tpu_torch.ops.chol import chol_quadratics

    t0 = time.perf_counter()
    rows = {r: eb_row_inputs(r) for r in (0, EB_ROW)}
    rows = {r: (args, cov()) for r, (args, cov) in rows.items()}
    mp, map_grams = map_cloud_inputs()
    map_grams = map_grams()
    _zero_counts()
    q_eb = {r: (fused_mix_quadratics(**args), chol_quadratics(cov, args["y"]))
            for r, (args, cov) in rows.items()}
    q8_map = fused_mix_quadratics(**mp, jitter=1e-3)
    q9_map = chol_quadratics(map_grams, mp["y"], jitter=1e-3,
                             use_pallas=True)
    q3_map = chol_quadratics(map_grams, mp["y"], jitter=1e-3)
    launches = _read_counts()
    _require_launched(launches, ("fused_mix_quadratics", "chol_nll",
                                 "chol_quadratics_lanes"),
                      "K8/K9 entry points")

    def row_ll(q):
        ll = -0.5 * (14 * math.log(2.0 * math.pi) + q["logdet"] + q["qyy"])
        return torch.logsumexp(ll, dim=0) - math.log(ll.shape[0])

    for r, (q8, q3) in q_eb.items():
        node = {k: _rel_err(q8[k], q3[k]) for k in EB_NODE_RTOL}
        ll8, ll3 = row_ll(q8), row_ll(q3)
        row_err = abs(float(ll8 - ll3)) / max(1.0, abs(float(ll3)))
        log(f"[15] EB row {r} {eb_grid()[r].tolist()} (n=14, B=1728, d=2, "
            f"f64), K8 against K3 on the materialized covariance: per node "
            f"logdet {node['logdet']:.3g}, qyy {node['qyy']:.3g} (tol "
            f"{EB_NODE_RTOL}); row log-likelihood {float(ll8):.12g} vs "
            f"{float(ll3):.12g}, rel err {row_err:.3g}"
            + (f" (tol {EB_ROW_RTOL:g})" if r == EB_ROW else " (not held)"))
        for k, e in node.items():
            if not e <= EB_NODE_RTOL[k]:
                raise AssertionError(f"K8 EB row {r} vs K3, {k}: {e:.3g}")
        if r == EB_ROW and not row_err <= EB_ROW_RTOL:
            raise AssertionError(f"K8 EB row {r} vs K3: {row_err:.3g}")
    eye = torch.eye(100, dtype=torch.float64, device="cuda")
    oracle_grams = _oracle_quads(map_grams.double() + 1e-3 * eye,
                                 mp["y"].double())
    diff = mp["x"].double()[:, None, :] - mp["x"].double()[None, :, :]
    d1 = torch.einsum("ijk,bk->bij", diff * diff, mp["r1"].double())
    d2 = torch.einsum("ijk,bk->bij", diff * diff, mp["r2"].double())
    p64 = mp["p"].double()
    w1, w2 = (p64 * p64)[:, None, None], ((1.0 - p64) ** 2)[:, None, None]
    oracle_x = _oracle_quads((w1 * torch.exp(-d1) + w2 * torch.exp(-d2))
                             / (w1 + w2) + 1e-3 * eye, mp["y"].double())
    e3 = _max_rel(q3_map, oracle_grams)
    e9 = _max_rel(q9_map, oracle_grams)
    e8 = _max_rel(q8_map, oracle_x)
    log(f"[15] MAP cloud (B=128, n=100, f32) against an f64 oracle of the "
        f"same inputs: K9 {e9:.3g}, K3 {e3:.3g} (the same Grams), K8 "
        f"{e8:.3g} (its Grams from x and the rates); tol "
        f"{ORACLE_F32_RTOL:g}; launches={launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    for name, e in (("K9", e9), ("K8", e8)):
        if not e <= ORACLE_F32_RTOL:
            raise AssertionError(f"{name} MAP cloud vs f64: {e:.3g}")
    return launches


# ---------------------------------------------------------------------------
# the study path: `python -m ccgp_tpu_torch sim_2d_aniso --f64
# --speculative 4` and the 1-D baselines
# ---------------------------------------------------------------------------

# `python -m ccgp_tpu sim_2d_aniso --cpu --f64 --speculative 4` (the JAX
# package on the CPU, seed 0) printed these: RMSPE to 4 places, coverage
# to 3
JAX_ANISO_RMSPE = {"combined": 0.0477, "single": 0.0485, "cgp": 0.0507}
JAX_ANISO_COVERAGE = {"combined": 0.846, "single": 0.845, "cgp": 0.859}
STUDY_RTOL = 1e-8


def run_aniso(device, design=None):
    """sim_2d_aniso at its own Config with speculative K = 4, f64, key 0,
    as the CLI runs it, on its own design or `design`; (result, seconds on
    the host clock)."""
    from ccgp_tpu_torch.experiments import sim_2d_aniso
    from ccgp_tpu_torch.ops import rng

    cfg = _aniso_cfg()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim_2d_aniso.run(cfg, key=rng.PRNGKey(0, device=device),
                           design=design, dtype=torch.float64, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _summary_line(res) -> str:
    s = res.summary
    return (" | ".join(f"{k} rmspe {s.rmspe[k]:.6f} coverage "
                       f"{s.coverage[k]:.4f}" for k in s.rmspe)
            + f" | calibration {s.average_quantile:.5f}")


def phase_study(twins=None):
    """16: the study on the card against its CPU record (`twins`' or run
    here); returns (launches, the card's result)."""
    _zero_counts()
    rg, gpu_s = run_aniso("cuda")
    launches = _read_counts()
    c = (twins.get("sim_2d_aniso") if twins is not None
         else _case_record(*run_aniso("cpu"), {}, None))
    cpu_s = c["secs"]
    mg, sg = rg.fit.mcmc, rg.summary
    err = _study_err(_case_record(rg, gpu_s, {}, None), c)
    err_z, err_s = err.pop("draws"), err.pop("summary")
    err.pop("sigma2")
    err_p = max(err.values())
    log(f"[16] sim_2d_aniso full width (n=14 maximin LHS, 25 x 25 lattice, "
        f"n_max 5000, samp 1000, net 1000, f64, K=4, 505 CGP candidates, "
        f"mlegp): n_recorded={mg.n_recorded} n_proposals={mg.n_proposals} "
        f"n_rounds={mg.n_rounds} chain_ok={rg.fit.chain_ok} sigma2="
        f"{float(rg.fit.sigma2):.10g} min_ess={rg.min_ess:.1f}; GPU: "
        f"{_summary_line(rg)}; GPU == CPU: draws {err_z:.3g}, predictions "
        f"{err_p:.3g}, summaries {err_s:.3g} (tol {STUDY_RTOL:g}); "
        f"{gpu_s:.1f} s on the GPU, {cpu_s:.1f} s on the CPU (host clock); "
        f"launches={launches}")
    if not rg.fit.chain_ok:
        raise AssertionError("study: chain unhealthy")
    if not all(math.isfinite(v) for v in sg.rmspe.values()):
        raise AssertionError(f"study: non-finite RMSPE {sg.rmspe}")
    if not (err_z <= STUDY_RTOL and err_p <= STUDY_RTOL
            and err_s <= STUDY_RTOL):
        raise AssertionError("study: GPU and CPU disagree")
    _require_launched(launches, ("fused_mix_mh_rounds", "chunk_draws"),
                      "study path")
    for k in JAX_ANISO_RMSPE:
        if not (abs(sg.rmspe[k] - JAX_ANISO_RMSPE[k]) <= 5e-5
                and abs(sg.coverage[k] - JAX_ANISO_COVERAGE[k]) <= 5e-4):
            raise AssertionError(f"study: {k} differs from the JAX "
                                 f"reference {JAX_ANISO_RMSPE[k]} / "
                                 f"{JAX_ANISO_COVERAGE[k]}")
    log(f"[16] the JAX package's summary of the same study (CPU, f64) "
        f"agrees to its printed digits: RMSPE {JAX_ANISO_RMSPE}, coverage "
        f"{JAX_ANISO_COVERAGE}")
    return launches, rg


def baselines_1d(device):
    """The two baselines on phase 12's data (`data_1d`: n = 8, function 1,
    50 points, f64) with `run_study`'s keys: kriging_mle (Matern(5)) ->
    kriging_predict(variant="reference"), and cgp_fit -> cgp_predict."""
    from ccgp_tpu_torch.infer.mle import kriging_mle
    from ccgp_tpu_torch.models.composite_gp import cgp_fit, cgp_predict
    from ccgp_tpu_torch.models.kriging import kriging_predict
    from ccgp_tpu_torch.ops import kernels, rng

    x, y, x_new, y_true, k_s = data_1d(SEED_1D, device)
    _, _, k_cgp, k_single = rng.split(k_s, 4)
    fam = kernels.matern_family(5.0)
    kp = kriging_predict(fam, x, y, kriging_mle(fam, x, y, k_single), x_new,
                         variant="reference")
    cp = cgp_predict(cgp_fit(x, y, k_cgp), x_new)
    return ({"single": kp, "cgp": cp},
            torch.tensor(y_true, dtype=torch.float64, device=device))


def phase_baselines_1d():
    t0 = time.perf_counter()
    g, truth = baselines_1d("cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    c, _ = baselines_1d("cpu")
    err = max(_rel_err(getattr(g[m], f), getattr(c[m], f)) for m in g
              for f in ("mean", "lower", "upper"))
    rm = {m: round(float(torch.sqrt(torch.mean((g[m].mean - truth) ** 2))),
                   6) for m in g}
    log(f"[16] 1-D baselines on phase 12's data (n=8, Matern(5) kriging "
        f"'reference', composite GP): GPU == CPU, predictions rel err "
        f"{err:.3g} (tol {PATH_1D_RTOL:g}); rmspe {rm}; {gpu_s:.1f} s on the "
        f"GPU")
    if not err <= PATH_1D_RTOL:
        raise AssertionError("1-D baselines: GPU and CPU disagree")
    if not all(math.isfinite(v) for v in rm.values()):
        raise AssertionError("1-D baselines: non-finite predictions")


# ---------------------------------------------------------------------------
# phase 17: whiten=True
# ---------------------------------------------------------------------------

# scripts/verify_whiten_oracle.py on the JAX package's CPU, n = 768, y
# offset 1000, f32: the quadratic's maximum relative error against a
# float64 oracle of the same f32 Gram, bordered and whitened
JAX_ORACLE_768 = {"bordered": 3.0e-3, "whitened": 4.2e-4}
ORACLE_JITTER = 1e-3


def oracle_problem():
    """The n = 768, offset-1000 problem of `scripts/verify_whiten_oracle.py`
    (its fourth; the generator drawn through the three before it): x (n, 2),
    y (n,) in float32 and 8 unconstrained points z (8, 4)."""
    r = np.random.default_rng(42)
    for n, offset in ((512, 0.0), (768, 0.0), (1024, 0.0), (768, 1000.0)):
        x = r.uniform(size=(n, 2)).astype(np.float32)
        y = (offset + np.sin(5 * x[:, 0]) * np.cos(3 * x[:, 1])
             + 0.05 * r.normal(size=n)).astype(np.float32)
        zs = (r.normal(size=(8, 4)) * 0.5 + [0.5, 0.5, 0.0, 0.0]
              ).astype(np.float32)
    return x, y, zs


def whiten_oracle():
    """The bordered quadratic (y - beta)' R^-1 (y - beta) = qyy - qoy^2 /
    qoo through `chol_quadratics` (K5, two batches of 4: K = 8 at n = 768
    lies outside the small-K envelope) and the whitened one through
    `likelihood.whitened_quadratics`, both in f32 on the card, against a
    float64 oracle of the same f32 Grams. Returns the maximum relative
    errors and K5's launches."""
    from ccgp_tpu_torch.models.combination import mixed_gram, unpack
    from ccgp_tpu_torch.models.likelihood import whitened_quadratics
    from ccgp_tpu_torch.ops import chol_smallk
    from ccgp_tpu_torch.ops.chol import chol_quadratics

    x, y, zs = (torch.tensor(a, device="cuda") for a in oracle_problem())
    grams = mixed_gram(_spec(), x, unpack(_spec(), zs)[0])     # (8, n, n)
    n = grams.shape[-1]
    k5 = chol_smallk.chol_quadratics_smallk.launches
    quads = [chol_quadratics(g, y, jitter=ORACLE_JITTER)
             for g in grams.split(4)]
    k5 = chol_smallk.chol_quadratics_smallk.launches - k5
    bordered = torch.cat([q["qyy"] - q["qoy"] ** 2 / q["qoo"]
                          for q in quads]).double()
    whitened = whitened_quadratics(grams, y, ORACLE_JITTER)[2].double()
    g64 = grams.double() + ORACLE_JITTER * torch.eye(
        n, dtype=torch.float64, device="cuda")
    chol = torch.linalg.cholesky(g64)
    rhs = torch.stack([y.double(), torch.ones_like(y, dtype=torch.float64)],
                      -1).expand(8, n, 2)
    w = torch.linalg.solve_triangular(chol, rhs, upper=False)
    a, b = w[..., 0], w[..., 1]
    beta = (a * b).sum(-1) / (b * b).sum(-1)
    resid = a - beta[:, None] * b
    quad = (resid * resid).sum(-1)
    err = {k: float(((v - quad).abs() / quad.abs()).max())
           for k, v in (("bordered", bordered), ("whitened", whitened))}
    return err, k5


def phase_whiten(bench_ms):
    """(a) The bench workload with whiten=True, phase 5's guards; K2 and K4
    launched (the cache rebuilt by `build_factors`), K1 never; (b) the
    small f64 slice with whiten=True, GPU against CPU; (c) the oracle
    check of `scripts/verify_whiten_oracle.py` at n = 768."""
    x, y, grid = bench_data()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, pred = _fit_predict(x, y, grid, 7, torch.float32, "cuda", 1e-3,
                             whiten=True, **BENCH_CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    mc = fit.mcmc
    mean = pred.mean.double().cpu().numpy()
    lo, hi = pred.lower.double().cpu().numpy(), pred.upper.double().cpu().numpy()
    y_true = f2(grid)
    rmspe = float(np.sqrt(np.mean((y_true - mean) ** 2)))
    cover = float(np.mean((y_true >= lo) & (y_true <= hi)))
    log(f"[17] whiten=True bench workload (n=100, K=4, f32, key 7): "
        f"n_recorded={mc.n_recorded} n_proposals={mc.n_proposals} "
        f"n_rounds={mc.n_rounds} chain_ok={fit.chain_ok} rmspe={rmspe:.5f} "
        f"coverage95={cover:.3f}; fit+predict {1e3 * wall:.1f} ms on the "
        f"host clock ({1e3 * wall / mc.n_rounds:.2f} ms/round) against "
        f"phase 5's median {bench_ms:.1f} ms (CUDA events); stash "
        f"{'kept' if mc.factors is not None else 'off'}; launches={launches}")
    if mean.shape != (625,) or not np.isfinite(mean).all():
        raise AssertionError("whiten: non-finite or misshapen predictions")
    if not (rmspe < 0.03 and cover >= 0.80 and fit.chain_ok):
        raise AssertionError(f"whiten: rmspe={rmspe} coverage={cover} "
                             f"chain_ok={fit.chain_ok}")
    if mc.factors is not None:
        raise AssertionError("whiten: the sampler kept a stash")
    _require_launched(launches, ("chunk_draws", "chol_factors_lanes"),
                      "whiten path")
    for k in ("fused_mix_mh_rounds", "fused_mix_mh_round",
              "fused_mix_quadratics_smallk"):
        if launches[k]:
            raise AssertionError(f"whiten: {k} was launched")
    small_slice_gpu_vs_cpu("[17]", whiten=True)
    _zero_counts()
    err, k5 = whiten_oracle()
    oracle = _read_counts()
    log(f"[17] whiten oracle (scripts/verify_whiten_oracle.py's n=768, y "
        f"offset 1000, 8 z, jitter {ORACLE_JITTER:g}, f32 on the card vs an "
        f"f64 oracle of the same Grams): max rel err of the quadratic "
        f"bordered (K5 x {k5}) {err['bordered']:.3g}, whitened "
        f"{err['whitened']:.3g}; the JAX package on the CPU: bordered "
        f"{JAX_ORACLE_768['bordered']:.1e}, whitened "
        f"{JAX_ORACLE_768['whitened']:.1e}")
    if k5 < 1:
        raise AssertionError("whiten oracle: K5 was not launched")
    if not err["whitened"] <= err["bordered"]:
        raise AssertionError(f"whiten oracle: whitened {err['whitened']} > "
                             f"bordered {err['bordered']}")
    launches = {k: launches[k] + oracle[k] for k in launches}
    return launches, wall


# ---------------------------------------------------------------------------
# phase 18: the maximum-entropy design path
# ---------------------------------------------------------------------------

# `ccgp_tpu.experiments.batch_me_design.run(Config(regenerate_first=True)`
# with speculative 4, PRNGKey(0), float64) on the JAX package's CPU
# printed these: the second batch to 4 places, the refit's RMSPE to 4 and
# coverage and calibration to 3 on the 25 x 25 lattice; the refit's chain
# (recorded, proposals, rounds). OFF is the same run's coverage and
# calibration over the 621 lattice points off the design (the corners are
# design points, where the intervals have a width of rounding size)
JAX_ME_SECOND = np.array([[-0.0241, 0.6407], [0.4658, -1.0],
                          [0.1141, -0.1983], [-0.5647, -0.6242],
                          [-0.4948, 0.4218], [0.6154, 0.6184],
                          [0.6172, -0.0551]])
JAX_ME_RMSPE = {"combined": 0.0454, "single": 0.0715, "cgp": 0.0443}
JAX_ME_COVERAGE = {"combined": 0.938, "single": 0.824, "cgp": 0.877}
JAX_ME_CALIBRATION = 0.499
JAX_ME_OFF_COVERAGE = {"combined": 0.937, "single": 0.829, "cgp": 0.878}
JAX_ME_OFF_CALIBRATION = 0.498
JAX_ME_CHAIN = (1380, 3360, 1583)
ME_RTOL = 1e-6      # the ME path, GPU against CPU
KMEDOIDS_RTOL = 1e-10
# `ccgp_tpu.design.kmedoids` on the same cloud (CPU, f64, PRNGKey(3), 16
# restarts): the medoids' indices and the cost
JAX_KMEDOIDS = ([3803, 2960, 5921, 2681, 6933, 3775, 2211], 428.6373284393122)


def off_design(res, n_axis=25):
    """Coverage per model and calibration of a `batch_me_design` result's
    refit study (the port's or the JAX package's) over the lattice points
    farther than 1e-6 from every design point."""
    u = np.linspace(-1, 1, n_axis)
    x_new = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    design = np.concatenate([res.d_first, res.d_second])
    keep = np.min(np.abs(x_new[:, None, :] - design[None]).max(-1), 1) > 1e-6
    y = np.asarray(res.study.y_true)[keep]
    cov = {m: float(np.mean((y >= np.asarray(p.lower)[keep])
                            & (y <= np.asarray(p.upper)[keep])))
           for m, p in res.study.predictions.items()}
    quant = np.asarray(res.study.predictions["combined"].quant)[keep]
    return cov, float(np.mean(quant))


def run_me(device):
    """`batch_me_design.run` at its own Config with regenerate_first=True
    and speculative K = 4, f64, key 0; (result, seconds on the host clock,
    seconds in the two design searches)."""
    from ccgp_tpu_torch.experiments import batch_me_design as bmd
    from ccgp_tpu_torch.models.combined_gp import MCMCConfig
    from ccgp_tpu_torch.ops import rng

    cfg = bmd.Config(regenerate_first=True)
    cfg = bmd.Config(**{**cfg.__dict__, "mcmc": MCMCConfig(
        **{**cfg.mcmc.__dict__, "speculative": 4})})
    searches = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            searches[0] += time.perf_counter() - t
            return out
        return call

    # the searches' share, timed around the module's two calls
    plain = bmd.me_design, bmd.batch_me_design
    bmd.me_design, bmd.batch_me_design = (timed(f) for f in plain)
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bmd.run(cfg, key=rng.PRNGKey(0, device=device),
                      dtype=torch.float64, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        bmd.me_design, bmd.batch_me_design = plain
    return res, time.perf_counter() - t0, searches[0]


def _chain(fit):
    mc = fit.mcmc
    return (mc.n_recorded, mc.n_proposals, mc.n_rounds, mc.converged)


def phase_me_design():
    """(a) The batch-sequential ME design path at full width on the GPU and
    on the CPU; (b) k-medoids on the in-repo subdesign cloud."""
    from ccgp_tpu_torch.design import augmented_me_criterion
    from ccgp_tpu_torch.models.combination import MixtureSpec, mixed_gram
    from ccgp_tpu_torch.ops import kernels, linalg

    _zero_counts()
    rg, gpu_s, gpu_search = run_me("cuda")
    launches = _read_counts()
    rc, cpu_s, cpu_search = run_me("cpu")
    for name, fg, fc in (("first fit", rg.fit, rc.fit),
                         ("refit", rg.study.fit, rc.study.fit)):
        if _chain(fg) != _chain(fc):
            raise AssertionError(f"ME path: the {name}'s chain differs GPU "
                                 f"{_chain(fg)} vs CPU {_chain(fc)}")
        if not fg.chain_ok:
            raise AssertionError(f"ME path: the {name}'s chain is unhealthy")
    sg, sc = rg.study.summary, rc.study.summary
    og, oc = off_design(rg), off_design(rc)
    errs = {
        "first design": _rel_err(torch.tensor(rg.d_first),
                                 torch.tensor(rc.d_first)),
        "second design": _rel_err(torch.tensor(rg.d_second),
                                  torch.tensor(rc.d_second)),
        "plug-in": max(_rel_err(getattr(rg.plug_in_params, f),
                                getattr(rc.plug_in_params, f))
                       for f in ("p", "theta1", "theta2")),
        "log-entropy": abs(rg.log_entropy - rc.log_entropy)
        / max(1.0, abs(rc.log_entropy)),
        "summaries": max([abs(sg.rmspe[k] - sc.rmspe[k]) for k in sc.rmspe]
                         + [abs(og[0][k] - oc[0][k]) for k in oc[0]]
                         + [abs(og[1] - oc[1])]),
    }
    # the second batch against a uniform one at the same plug-in
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    x1 = torch.tensor(rg.d_first, device="cuda")
    chol = linalg.jitter_cholesky(mixed_gram(spec, x1, rg.plug_in_params))
    rand = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (7, 2)),
                        device="cuda")
    rand_le = -float(augmented_me_criterion(spec, x1, chol, rand,
                                            rg.plug_in_params))
    log(f"[18] batch_me_design full width (14 + 7 points, 25 optimum_lhs "
        f"starts, maxiter 200, n_max 5000, samp 1000, net 1000, f64, K=4, "
        f"mlegp, 505 CGP candidates, 25 x 25 lattice): first fit "
        f"{_chain(rg.fit)}, refit {_chain(rg.study.fit)} chain_ok="
        f"{rg.study.fit.chain_ok}; second batch log-entropy "
        f"{rg.log_entropy:.10g} against a uniform batch's {rand_le:.6g}; "
        f"plug-in p={float(rg.plug_in_params.p):.10g} theta1="
        f"{float(rg.plug_in_params.theta1):.10g} theta2="
        f"{float(rg.plug_in_params.theta2):.10g}; GPU: "
        f"{_summary_line(rg.study)}; off the design (621 points): coverage "
        f"{ {k: round(v, 4) for k, v in og[0].items()} } calibration "
        f"{og[1]:.5f}; GPU == CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {ME_RTOL:g}); {gpu_s:.1f} s on the GPU ({gpu_search:.1f} "
        f"s in the two design searches), {cpu_s:.1f} s on the CPU "
        f"({cpu_search:.1f} s), host clock; launches={launches}")
    log(f"[18] second-batch design (GPU):\n{np.round(rg.d_second, 4)}")
    for d in (rg.d_first, rg.d_second):
        if not np.all(np.abs(d) <= 1.0):
            raise AssertionError("ME path: a design point outside the box")
    if not rg.log_entropy > rand_le:
        raise AssertionError("ME path: the second batch scores below a "
                             "uniform batch")
    if not all(math.isfinite(v) for v in sg.rmspe.values()):
        raise AssertionError(f"ME path: non-finite RMSPE {sg.rmspe}")
    if not all(v <= ME_RTOL for v in errs.values()):
        raise AssertionError(f"ME path: GPU and CPU disagree: {errs}")
    _require_launched(launches, ("fused_mix_mh_rounds", "chunk_draws"),
                      "ME design path")
    jax_ok = (np.all(np.abs(rg.d_second - JAX_ME_SECOND) <= 5e-5 + 1e-12)
              and _chain(rg.study.fit)[:3] == JAX_ME_CHAIN
              and all(abs(sg.rmspe[k] - v) <= 5e-5
                      for k, v in JAX_ME_RMSPE.items())
              and all(abs(sg.coverage[k] - JAX_ME_COVERAGE[k]) <= 5e-4
                      for k in ("combined", "cgp"))
              and all(abs(og[0][k] - v) <= 5e-4
                      for k, v in JAX_ME_OFF_COVERAGE.items())
              and abs(og[1] - JAX_ME_OFF_CALIBRATION) <= 5e-4)
    if not jax_ok:
        raise AssertionError("ME path: differs from the JAX package's run")
    log(f"[18] the JAX package's run of the same path (CPU, f64) agrees to "
        f"its printed digits: the second batch, the refit chain "
        f"{JAX_ME_CHAIN}, RMSPE {JAX_ME_RMSPE}, coverage of combined and cgp "
        f"{JAX_ME_COVERAGE}, off-design coverage {JAX_ME_OFF_COVERAGE} and "
        f"calibration {JAX_ME_OFF_CALIBRATION} (on the whole lattice the "
        f"single GP's coverage reads {sg.coverage['single']:.3f} against "
        f"JAX's {JAX_ME_COVERAGE['single']}, calibration "
        f"{sg.average_quantile:.3f} against {JAX_ME_CALIBRATION}: the four "
        f"corners, decided by rounding)")

    # (b) k-medoids on the in-repo cloud, as scripts/run_kmedoids_full.py
    # runs it: 7000 points, k = 7, PRNGKey(3), 16 restarts
    from ccgp_tpu_torch.design import kmedoids
    from ccgp_tpu_torch.ops import rng

    cloud = np.load("results/regenerated_subdesigns.npy")
    km, secs = {}, {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km[dev] = kmedoids(torch.tensor(cloud, device=dev), 7,
                           rng.PRNGKey(3, device=dev), n_restarts=16)
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    idx_g, idx_c = km["cuda"].medoid_idx.cpu(), km["cpu"].medoid_idx
    cost_err = abs(float(km["cuda"].cost) - float(km["cpu"].cost)) / abs(
        float(km["cpu"].cost))
    log(f"[18] kmedoids on results/regenerated_subdesigns.npy ({cloud.shape[0]}"
        f" points, k=7, PRNGKey(3), 16 restarts): medoids {idx_c.tolist()}, "
        f"cost {float(km['cpu'].cost):.12g}; GPU == CPU: indices "
        f"{torch.equal(idx_g, idx_c)}, cost rel err {cost_err:.3g} (tol "
        f"{KMEDOIDS_RTOL:g}); {secs['cuda']:.2f} s on the GPU, "
        f"{secs['cpu']:.2f} s on the CPU")
    if not (torch.equal(idx_g, idx_c) and cost_err <= KMEDOIDS_RTOL):
        raise AssertionError("kmedoids: GPU and CPU disagree")
    jax_err = abs(float(km["cuda"].cost) - JAX_KMEDOIDS[1]) / JAX_KMEDOIDS[1]
    if not (idx_g.tolist() == JAX_KMEDOIDS[0] and jax_err <= KMEDOIDS_RTOL):
        raise AssertionError(f"kmedoids: differs from the JAX package's "
                             f"{JAX_KMEDOIDS}")
    log(f"[18] kmedoids: the JAX package's medoids and cost on the same "
        f"cloud matched (cost rel err {jax_err:.3g})")
    return launches, gpu_s, cpu_s


# ---------------------------------------------------------------------------
# the data-file case studies
# ---------------------------------------------------------------------------

GV_INPUTS = ["slope", "angle", "top.layer3", "bot.layer3", "vs2", "vs3",
             "vs4", "density", "freq"]
GV_POINTS = 200     # the ground-vibrations data set
GV_TRAIN = 50


def _write_r_table(path, names, rows) -> None:
    """An R `write.table` file: quoted header, quoted 1-based row names,
    values as `repr(float)` (exact)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(" ".join(f'"{n}"' for n in names) + "\n")
        for i, r in enumerate(rows):
            fh.write(f'"{i + 1}" ' + " ".join(repr(float(v)) for v in r)
                     + "\n")


def gv_data_root(root, samples=range(1, 10)):
    """Rebuild the ground-vibrations size-50 splits from the repo's tables
    `results/GV Size 50 Results {1..9}.txt` under `root`, in the layout and
    R format `eval.datasets.load_ground_vibrations` reads (9 standardized
    inputs, then y), and return root as a `pathlib.Path`.

    Table i holds the 150 test points of sample i, in test-set order, with
    their inputs and `y.true`; the nine tables together hold the 200
    points of the data set, so sample i's training set is the 50 points
    not in table i. Test rows keep their table's order; training rows
    come in the order of their first appearance across tables 1..9. The
    reference's own training-row order is not recorded anywhere in the
    repo: another order permutes the training Gram, which changes the
    rounding of every computation on it and nothing else.

    Sizes 90 cannot be rebuilt: the repo holds no size-90 table."""
    from pathlib import Path

    from ccgp_tpu_torch.eval import results

    here = Path(__file__).resolve().parent / "results"
    tables = {}
    for i in range(1, 10):
        head, rows = results.read_comparison_table(
            here / f"GV Size 50 Results {i}.txt")
        tables[i] = rows[:, [head.index(c) for c in GV_INPUTS + ["y.true"]]]
    order = {}
    for i in range(1, 10):
        for r in tables[i]:
            order.setdefault(tuple(r), len(order))
    if len(order) != GV_POINTS:
        raise AssertionError(f"the GV tables hold {len(order)} distinct "
                             f"points, not {GV_POINTS}")
    everything = np.array(list(order))
    root = Path(root)
    d = root / "Ground Vibrations Emulator"
    for i in samples:
        test = {tuple(r) for r in tables[i]}
        train = np.array([r for r in everything if tuple(r) not in test])
        if len(test) != GV_POINTS - GV_TRAIN or len(train) != GV_TRAIN:
            raise AssertionError(f"GV sample {i}: {len(train)} training and "
                                 f"{len(test)} test points")
        names = GV_INPUTS + ["y"]
        _write_r_table(d / "Training Sets"
                       / f"Training Set Size 50 Sample {i}.txt", names, train)
        _write_r_table(d / "Test Sets" / f"Test Set Size 50 Sample {i}.txt",
                       names, tables[i])
    return root


def heat_standin_response(x: np.ndarray) -> np.ndarray:
    """A smooth response on the unit 4-cube standing in for the Qian heat
    exchanger's `ya`, which is not in the repo: a Gaussian bump in (m, k),
    a bilinear term in (Tin, Twall) and a gentle oscillation."""
    m, tin, k, tw = x.T
    return (20.0 * np.exp(-2.0 * (m - 0.3) ** 2 - (k - 0.6) ** 2)
            + 8.0 * tin * tw + 2.0 * np.sin(3.0 * m + 2.0 * tw))


def _lhs(g, n, d) -> np.ndarray:
    return (np.stack([g.permutation(n) for _ in range(d)], 1)
            + g.uniform(size=(n, d))) / n


def heat_standin_grid() -> np.ndarray:
    """A stand-in for the reference's 624 x 4 heat-exchanger hyperprior
    grid, in the ranges of `eb_grid`: a1 in 4 steps over [3, 5], b1 in 6
    geometric steps over [4, 16], a2 in {3, 5}, b2 in 13 geometric steps
    over [16, 256] (4 x 6 x 2 x 13 = 624 rows)."""
    return np.array([(a1, b1, a2, b2) for a1 in np.linspace(3.0, 5.0, 4)
                     for b1 in np.geomspace(4.0, 16.0, 6) for a2 in (3.0, 5.0)
                     for b2 in np.geomspace(16.0, 256.0, 13)])


SWEEP_DESIGN_SEED = 2014   # default_rng seed of the sweep's stand-in designs
SWEEP_DESIGNS = 100        # the reference ships Train_Design_{1..100}


def sweep_standin_designs(n_designs=SWEEP_DESIGNS) -> np.ndarray:
    """(n_designs, 14, 2) stand-ins for the reference's Train_Designs,
    which are not in the repo: size-14 Latin hypercubes on [0, 1]^2 drawn
    one after another from `default_rng(SWEEP_DESIGN_SEED)`."""
    g = np.random.default_rng(SWEEP_DESIGN_SEED)
    return np.stack([_lhs(g, 14, 2) for _ in range(n_designs)])


def standin_data_root(root, heat_rows=None):
    """Write stand-ins for the files `heat_exchanger` and
    `sim_2d_iso_advanced` read, which are not in the repo, under `root` in
    the loaders' shapes and R formats; return root as a `pathlib.Path`:

    * the Qian training and test sets: a 64- and a 14-point LHS on the unit
      4-cube (`default_rng(0)`) with `heat_standin_response`;
    * the heat grid: `heat_standin_grid()`, or its rows `heat_rows` (a
      sequence of row indices);
    * `maximin 14 pts.txt`: phase 16's design, the 14-point maximin LHS
      that `sim_2d_aniso.run` draws from PRNGKey(0);
    * the 2-D grid: `eb_grid()`'s 60 rows;
    * `Training Designs/Train_Design_{1..100}.txt`: the sweep's designs,
      `sweep_standin_designs()`, in R's header format.

    Numbers from these files are not the reference's."""
    from pathlib import Path

    from ccgp_tpu_torch.design.lhs import maximin_lhs
    from ccgp_tpu_torch.ops import rng

    root = Path(root)
    g = np.random.default_rng(0)
    heat = root / "Heat Exchanger Emulator"
    names = ["m", "Tin", "k", "Twall", "ya"]
    for name, n in (("Qian Training Set.txt", 64), ("Qian Test Set.txt", 14)):
        x = _lhs(g, n, 4)
        _write_r_table(heat / name, names,
                       np.column_stack([x, heat_standin_response(x)]))
    pars = ["a1", "b1", "a2", "b2"]
    grid = heat_standin_grid()
    _write_r_table(heat / "hyperpars.matrix.txt", pars,
                   grid if heat_rows is None else grid[list(heat_rows)])
    d2 = root / "2D Codes and Designs"
    k_d, _ = rng.split(rng.PRNGKey(0, device="cpu"))
    design = maximin_lhs(k_d, 14, 2).numpy()
    d2.mkdir(parents=True, exist_ok=True)
    with open(d2 / "maximin 14 pts.txt", "w") as fh:
        fh.writelines(f"{float(a)!r} {float(b)!r}\n" for a, b in design)
    _write_r_table(d2 / "hyperpars.matrix.txt", pars, eb_grid())
    for i, dsg in enumerate(sweep_standin_designs()):
        _write_r_table(d2 / "Training Designs" / f"Train_Design_{i + 1}.txt",
                       ["x1", "x2"], dsg)
    return root


# the JAX package's golden study, `ground_vibrations.Config(sample=1,
# compat_mlegp=True)`, full budget, PRNGKey(1), CPU f64, speculative 0
# (`scripts/run_goldens.py:76-82`), as printed in RESULTS_compat_mlegp.md;
# the JAX package printed the same digits on the files `gv_data_root`
# rebuilds (its chain: 2320 recorded of 5685 proposals)
JAX_GV_RMSPE = {"combined": 2.719, "single": 2.687, "cgp": 2.856}
JAX_GV_COVERAGE = {"combined": 0.973, "single": 0.867, "cgp": 0.727}
JAX_GV_CALIBRATION = 0.499
JAX_GV_CHAIN = (2320, 5685)
GV_R_ATOL = 1e-6        # the single GP against R's archived columns
EB_RTOL = 1e-9          # EB log-likelihoods, GPU against CPU, same inputs
COMPAT_TABLE = "results_compat_mlegp/GV Size 50 Results 1.txt"
# the studies phase 19 runs on the GPU and on the CPU: (module, Config
# overrides, key, run keywords); K = 4, f64, each study's full budget
CASES = {
    "ground_vibrations": ("ground_vibrations", {}, 1, {"run_cgp": False}),
    "heat_exchanger": ("heat_exchanger", {"eb_search": True}, 0, {}),
    "sim_2d_iso_advanced fixed": ("sim_2d_iso_advanced",
                                  {"compat": "fixed"}, 0, {}),
    "sim_2d_iso_advanced reference": ("sim_2d_iso_advanced",
                                      {"compat": "reference"}, 0, {}),
}
# the stages timed inside a study, by the names the study modules import
STAGES = ("mlegp_fit", "choose_hyperpars", "fit_combined_gp", "cgp_fit")


def _data_root(root):
    """Point the port's loaders at root; returns the previous roots."""
    from ccgp_tpu_torch.eval import datasets

    before = datasets._DEFAULT_ROOTS
    datasets._DEFAULT_ROOTS = (str(root),)
    return before


def run_case(name, device, speculative=4, run_kw=None, **over):
    """A phase-19 study of `CASES` on `device`, its Config changed by
    `over` and its run keywords replaced by `run_kw` where given: its
    result, seconds on the host clock, seconds per stage (`STAGES`, around
    the module-level functions the study calls), and where it ran an EB
    scan its choice and the scan's (args, kwargs)."""
    import importlib

    from ccgp_tpu_torch.experiments import common
    from ccgp_tpu_torch.models.combined_gp import MCMCConfig
    from ccgp_tpu_torch.ops import rng

    modname, cfg_over, seed, case_kw = CASES[name]
    run_kw = case_kw if run_kw is None else run_kw
    mod = importlib.import_module(f"ccgp_tpu_torch.experiments.{modname}")
    cfg = mod.Config(**{**cfg_over, **over})
    cfg = type(cfg)(**{**cfg.__dict__, "mcmc": MCMCConfig(
        **{**cfg.mcmc.__dict__, "speculative": speculative})})
    stages, choice = {}, []

    def timed(stage, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t
            if stage == "choose_hyperpars":
                choice.append((out, (a, kw)))
            return out
        return call

    patched = [(m, s, getattr(m, s)) for m in (mod, common) for s in STAGES
               if hasattr(m, s)]
    for m, s, fn in patched:
        setattr(m, s, timed(s, fn))
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mod.run(cfg, key=rng.PRNGKey(seed, device=device),
                      dtype=torch.float64, device=device, **run_kw)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for m, s, fn in patched:
            setattr(m, s, fn)
    return (res, secs, stages) + (choice[0] if choice else (None, None))


def _case_record(res, secs, stages, choice) -> dict:
    """What phase 19 compares of a study run, its tensors on the CPU."""
    s = res.summary
    out = {"chain": _chain(res.fit), "chain_ok": res.fit.chain_ok,
           "zs": res.fit.zs.cpu(), "sigma2": float(res.fit.sigma2),
           "predictions": {m: {f: torch.as_tensor(getattr(p, f))
                               for f in ("mean", "lower", "upper", "quant")
                               if getattr(p, f) is not None}
                           for m, p in res.predictions.items()},
           "summary": (s.rmspe, s.coverage, s.average_quantile),
           "secs": secs, "stages": stages}
    if choice is not None:
        out["eb"] = (int(choice.index), choice.likelihoods.cpu())
    return out


def _compare_case(name, g, c, rows=None):
    """A study's GPU record against its CPU record: the same chain, EB row
    and chain health; draws, predictions and summaries within STUDY_RTOL.
    `rows`: the GPU's grid rows that the CPU scanned, in order, where it
    scanned a subset. Returns the largest relative error and that of the
    two scans' log-likelihoods, which carry the difference of the two
    devices' `mlegp_fit` plug-ins (BFGS's stopping point)."""
    if g["chain"] != c["chain"] or g["chain_ok"] != c["chain_ok"]:
        raise AssertionError(f"{name}: chain {g['chain']} on the GPU, "
                             f"{c['chain']} on the CPU")
    errs = [_rel_err(g["zs"], c["zs"]),
            abs(g["sigma2"] - c["sigma2"]) / max(1.0, abs(c["sigma2"]))]
    if set(g["predictions"]) != set(c["predictions"]):
        raise AssertionError(f"{name}: models differ")
    for m, fields in c["predictions"].items():
        errs += [_rel_err(g["predictions"][m][f], v)
                 for f, v in fields.items()]
    (gr, gc, gq), (cr, cc, cq) = g["summary"], c["summary"]
    errs += [abs(gr[k] - cr[k]) for k in cr] + [abs(gc[k] - cc[k])
                                                for k in cc]
    errs.append(abs(gq - cq))
    if not max(errs) <= STUDY_RTOL:
        raise AssertionError(f"{name}: GPU and CPU differ by "
                             f"{max(errs):.3g} > {STUDY_RTOL:g}")
    eb_err = None
    if "eb" in c:
        rows = list(range(len(g["eb"][1]))) if rows is None else list(rows)
        if g["eb"][0] != rows[c["eb"][0]]:
            raise AssertionError(f"{name}: EB row {g['eb'][0]} on the GPU, "
                                 f"{rows[c['eb'][0]]} on the CPU")
        eb_err = _rel_err(g["eb"][1][rows], c["eb"][1])
    return max(errs), eb_err


def _eb_same_inputs(name, choice, call, rows):
    """The GPU scan's log-likelihoods against the CPU's on the same inputs
    (the GPU study's x, y, sigma2 and nodes; the grid rows `rows`), within
    EB_RTOL. Returns the relative error."""
    from ccgp_tpu_torch.eb import choose_hyperpars

    (spec, x, y, grid, s2), kw = call
    ref = choose_hyperpars(spec, x.cpu(), y.cpu(), np.asarray(grid)[rows],
                           s2, **{**kw, "device": "cpu"})
    err = _rel_err(choice.likelihoods.cpu()[rows], ref.likelihoods)
    if not err <= EB_RTOL:
        raise AssertionError(f"{name}: EB log-likelihoods on the same "
                             f"inputs differ by {err:.3g} > {EB_RTOL:g}")
    return err


def _stage_line(rec) -> str:
    secs = rec["secs"]
    return ", ".join(f"{k} {v:.1f} s ({100 * v / secs:.0f}%)"
                     for k, v in rec["stages"].items())


def gv_golden(root):
    """19a: the golden study on the GPU as `scripts/run_goldens.py:76-82`
    ran it in JAX, checked against R's archived fit and the JAX run; its
    table written and read back. Returns (result, launches, seconds)."""
    from pathlib import Path

    from ccgp_tpu_torch.eval import results
    from ccgp_tpu_torch.eval.datasets import load_ground_vibrations

    _zero_counts()
    res, secs, stages, _, _ = run_case("ground_vibrations", "cuda",
                                       speculative=0, run_kw={},
                                       compat_mlegp=True)
    launches = _read_counts()
    s = res.summary
    gv = load_ground_vibrations(50, 1)
    table = (Path(root) / "Ground Vibrations Emulator" / "Results"
             / "Size 50 Results 1.txt")
    results.write_comparison_table(table, gv["x_test"], GV_INPUTS,
                                   res.predictions, res.y_true)
    back = results.summary_from_table(table)
    if back != s:
        raise AssertionError(f"GV: the written table's summary {back} is "
                             f"not the study's {s}")
    cols, tab = results.read_comparison_table(
        Path(__file__).resolve().parent / COMPAT_TABLE)
    if not np.array_equal(tab[:, cols.index("y.true")], res.y_true):
        raise AssertionError("GV: the test set is not the archived table's")
    got = {"y.hat": res.predictions["single"].mean,
           "LL": res.predictions["single"].lower,
           "UL": res.predictions["single"].upper}
    err_r = max(float(np.max(np.abs(v - tab[:, cols.index(f"{k}.single")])))
                for k, v in got.items())
    other = {f"{c}.{m}": float(np.max(np.abs(
        getattr(res.predictions[k], f) - tab[:, cols.index(f"{c}.{m}")])))
        for k, m in (("combined", "Combined"), ("cgp", "CGP"))
        for c, f in (("y.hat", "mean"), ("LL", "lower"), ("UL", "upper"))}
    mc = res.fit.mcmc
    split = _stage_line({"secs": secs, "stages": stages})
    log(f"[19a] ground_vibrations golden (size 50 sample 1, rebuilt data, "
        f"compat_mlegp, n=50 d=9, n_max 5000, samp 1000, net 1000, f64, "
        f"speculative 0, PRNGKey(1)): {secs:.1f} s on the GPU ({split}); "
        f"chain {mc.n_recorded} / "
        f"{mc.n_proposals} (JAX on the same files {JAX_GV_CHAIN}), "
        f"chain_ok={res.fit.chain_ok}, sigma2={float(res.fit.sigma2):.12g}; "
        f"{_summary_line(res)}; launches={launches}")
    log(f"[19a] single GP against R's archived columns ({COMPAT_TABLE}): "
        f"max abs diff {err_r:.3g} (tol {GV_R_ATOL:g}); the other columns "
        f"of that table (the JAX package's run): " + ", ".join(
            f"{k} {v:.3g}" for k, v in other.items())
        + "; the written table's summary equals the study's")
    if not err_r < GV_R_ATOL:
        raise AssertionError(f"GV: single GP {err_r:.3g} from R's fit")
    if not res.fit.chain_ok:
        raise AssertionError("GV: chain unhealthy")
    for k in JAX_GV_RMSPE:
        if not (abs(s.rmspe[k] - JAX_GV_RMSPE[k]) <= 5e-4
                and abs(s.coverage[k] - JAX_GV_COVERAGE[k]) <= 5e-4):
            raise AssertionError(f"GV: {k} {s.rmspe[k]} / {s.coverage[k]} "
                                 f"differs from the JAX run's "
                                 f"{JAX_GV_RMSPE[k]} / {JAX_GV_COVERAGE[k]}")
    if not abs(s.average_quantile - JAX_GV_CALIBRATION) <= 5e-4:
        raise AssertionError(f"GV: calibration {s.average_quantile}")
    log(f"[19a] the summary matches RESULTS_compat_mlegp.md's printed "
        f"digits (the JAX package's run; the same on the rebuilt files): "
        f"RMSPE {JAX_GV_RMSPE}, coverage {JAX_GV_COVERAGE}, calibration "
        f"{JAX_GV_CALIBRATION}")
    return res, launches, secs


def gv_serialize(res, tmp):
    """19e: the golden fit saved on the card, loaded on the CPU and on the
    card, and predicted again with one key."""
    from ccgp_tpu_torch.eval.datasets import load_ground_vibrations
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.combined_gp import predict_combined_gp
    from ccgp_tpu_torch.models.serialize import load_fit, save_fit
    from ccgp_tpu_torch.ops import kernels, rng

    gv = load_ground_vibrations(50, 1)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=9)
    path = tmp / "gv_fit.npz"
    save_fit(path, res.fit)
    preds = {}
    for tag, fit, dev in (("saved", res.fit, "cuda"),
                          ("loaded on the CPU", load_fit(path, "cpu"), "cpu"),
                          ("loaded on the card", load_fit(path, "cuda"),
                           "cuda")):
        preds[tag] = predict_combined_gp(
            spec, fit, gv["x_train"], gv["x_test"],
            rng.PRNGKey(5, device=dev), device=dev)
    fields = ("mean", "lower", "upper", "quant")
    same = all(torch.equal(getattr(preds["saved"], f),
                           getattr(preds["loaded on the card"], f))
               for f in fields)
    err = max(_rel_err(getattr(preds["loaded on the CPU"], f),
                       getattr(preds["saved"], f)) for f in fields)
    log(f"[19e] save_fit / load_fit of the golden fit ({path.stat().st_size}"
        f" bytes): the card's prediction from the reloaded fit equals the "
        f"saved fit's bit for bit: {same}; from the fit loaded on the CPU, "
        f"predicted there, rel err {err:.3g} (tol {STUDY_RTOL:g}; the "
        f"CPU's normals part from the card's by ulps)")
    if not (same and err <= STUDY_RTOL):
        raise AssertionError("serialize: the reloaded fit predicts "
                             "otherwise")


def _gv_rounds_args(rr, z, seed):
    """K1's inputs at the GV study's shape: the rebuilt sample-1 training
    set (n = 50, d = 9), the isotropic SE x SE model with its priors,
    K = 4 candidates per round around z, f64, stash on."""
    from ccgp_tpu_torch.eval.datasets import load_ground_vibrations
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.likelihood import cand_model_for
    from ccgp_tpu_torch.models.priors import InverseGamma
    from ccgp_tpu_torch.ops import kernels

    gv = load_ground_vibrations(50, 1)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=9)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,  # noqa: E731
                               device="cuda")
    x = t(gv["x_train"])
    r = np.random.default_rng(seed)
    kk, dim = 4, 3
    return dict(x=x, y=t(gv["y_train"]), z=t(z), lp_val=t(-1e6),
                lp_beta=t(0.0), sigma2=t(10.25),
                deltas=t(0.3 * r.normal(size=(rr * kk, dim))),
                log_u=t(np.log(r.uniform(size=(rr, kk)))),
                model=cand_model_for(spec, x, InverseGamma(3, 1),
                                     InverseGamma(5, 75)),
                jitter=0.0, stash=True)


def _heat_eb_row(row):
    """K3's inputs at the heat EB scan's shape: row `row` of the stand-in
    grid, its 1000 Halton nodes' covariances sigma2_t R_mix + tau^2 J over
    the stand-in training set (n = 64, d = 4), tau = 50, f64."""
    from ccgp_tpu_torch.eb.halton import halton
    from ccgp_tpu_torch.eval.datasets import load_qian
    from ccgp_tpu_torch.models.combination import (
        MixParams, MixtureSpec, mixed_gram)
    from ccgp_tpu_torch.ops import kernels
    from ccgp_tpu_torch.ops.special import invgamma_quantile

    q = load_qian()
    a1, b1, a2, b2 = heat_standin_grid()[row]
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,  # noqa: E731
                               device="cuda")
    p = t(halton(1000, 1)[:, 0])
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=4)
    params = MixParams(p=p, theta1=invgamma_quantile(p, a1, b1),
                       theta2=invgamma_quantile(p, a2, b2))
    s2t = 30.0 * (p * p + (1.0 - p) ** 2)
    covs = s2t[:, None, None] * mixed_gram(spec, t(q["x_train"]), params)
    return covs + 50.0 ** 2, t(q["y_train"])


def new_shape_kernels(z_gv, eb_row):
    """19f: K1 at the GV shape (K = 4, n = 50, d = 9, f64) and K3 (with K4)
    at the heat EB shape (B = 1000, n = 64, f64) against their twins bit
    for bit, then timed as phase 6 times them. Returns {(kernel, shape):
    (ms, plain ms, library ms, bound)}."""
    from ccgp_tpu_torch.models.combination import MixtureSpec, mixed_gram, unpack
    from ccgp_tpu_torch.ops import chol_lanes, chol_smallk, kernels

    bits = recs = 0
    for rr, seed in ((20, 1), (120, 2), (20, 3)):
        args = _gv_rounds_args(rr, z_gv, seed)
        _, b = _compare_rounds(args, F64_RTOL, f"GV shape n=50 d=9 K=4 "
                               f"R={rr} f64 (seed {seed})", tag="[19f]")
        bits, recs = bits + b, recs + rr
    if bits != recs:
        raise AssertionError(f"K1 at the GV shape: {bits} of {recs} records "
                             f"bit-equal")
    covs, y = _heat_eb_row(eb_row)
    _, nan, unequal = _compare_lanes(covs, y, 0.0, f"heat EB row {eb_row}")
    if unequal:
        raise AssertionError(f"K3/K4 at the heat EB shape: {unequal}")
    log(f"[19f] K1 at the GV shape: {bits} of {recs} records bit-equal; K3 "
        f"and K4 at the heat EB shape (B=1000, n=64, f64, row {eb_row}, "
        f"layout {chol_lanes.lanes_layout(64, 1000, torch.float64)[:2]}): "
        f"bit-equal to the twins, {nan} NaN logdets")

    out = {}
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=9)
    for rr in (120, 20):
        args = _gv_rounds_args(rr, z_gv, rr)
        fn = lambda: chol_smallk.fused_mix_mh_rounds(**args)  # noqa: E731
        call = _cuda_ms(fn, 5)
        k, how = _kernel_ms("fused_mix_mh_rounds", fn, 3, call)
        p = _cuda_ms(lambda: chol_smallk.fused_mix_mh_rounds_plain(**args), 1)
        n, d, kk, dim = 50, 9, 4, 3
        cz = (args["z"][None, :] + args["deltas"]).reshape(rr, kk, -1)
        grams = mixed_gram(spec, args["x"], unpack(spec, cz)[0])
        lib_fn = lambda: [torch.linalg.cholesky_ex(grams[r])  # noqa: E731
                          for r in range(rr)]
        lib_call = _cuda_ms(lib_fn, 3)
        lib, lib_how = _library_ms(lib_fn, 3, lib_call)
        nbytes = 8 * (n * d + n + dim + 3 + rr * kk * dim + rr * kk
                      + rr * (dim + 2) + rr * 2 + rr * (n + 2) * n)
        bound = _bound(nbytes, (rr * kk * n * (n + 1) / 2 * (3 * d + 6),
                                PEAK_VEC[8]),
                       (rr * kk * (n ** 3 / 3 + 2 * n * n), PEAK_OPS[8]))
        log(f"[19f] fused_mix_mh_rounds GV shape n=50 d=9 K=4 R={rr} f64 "
            f"stash: kernel {k:.4f} ms {how} ({1e3 * k / rr:.1f} us/round; "
            f"{call:.4f} ms per call) on a cluster of "
            f"{chol_smallk.rounds_layout(n, kk)[0]} SMs, plain {p:.1f} ms "
            f"per call, cholesky_ex x R {lib:.4f} ms {lib_how} ({lib_call:.4f}"
            f" ms per call), bound {bound[0]:.2e} ms ({bound[1]})")
        out[("fused_mix_mh_rounds", f"GV R={rr}")] = (k, p, lib, bound)
    fn = lambda: chol_lanes.chol_quadratics_lanes(covs, y)  # noqa: E731
    call = _cuda_ms(fn, 20)
    k, how = _kernel_ms("chol_quadratics_lanes", fn, 10, call)
    p = _cuda_ms(lambda: chol_lanes.chol_quadratics_lanes_plain(covs, y), 1)
    lib_fn = lambda: _library_lanes(covs, y, 0.0)  # noqa: E731
    lib_call = _cuda_ms(lib_fn, 10)
    lib, lib_how = _library_ms(lib_fn, 10, lib_call)
    bound = _lanes_bound(1000, 64, 8, False)
    log(f"[19f] chol_quadratics_lanes heat EB row B=1000 n=64 f64: kernel "
        f"{k:.4f} ms {how} ({call:.4f} ms per call), plain {p:.2f} ms per "
        f"call, library {lib:.4f} ms {lib_how} ({lib_call:.4f} ms per call), "
        f"bound {bound[0]:.2e} ms ({bound[1]})")
    out[("chol_quadratics_lanes", "heat EB row")] = (k, p, lib, bound)
    return out


HEAT_CPU_ROWS = 16   # the GPU's best heat rows the CPU scans, with a spread


def phase_case_studies(twins=None):
    """19: the data-file case studies: 19a the golden GV study on the GPU;
    19b-19d each study on the GPU and then on the CPU (the heat scan on
    the CPU over the GPU's best HEAT_CPU_ROWS rows and every 48th: 624
    rows of 1000 64 x 64 factorizations on the CPU take minutes; the
    others `twins`' records where given), each EB scan also against a CPU
    scan of the same inputs; 19e save / load; 19f the kernels at the new
    shapes. Returns ({path: launches}, timings)."""
    import shutil
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix="ccgp_case_studies_"))
    before = _data_root(tmp)
    paths, gpu_s, cpu_s = {}, 0.0, 0.0
    try:
        gv_data_root(tmp)
        standin_data_root(tmp)
        golden, paths["case study GV golden"], gpu_s = gv_golden(tmp)
        for name in CASES:
            _zero_counts()
            res, secs, stages, choice, call = run_case(name, "cuda")
            launches = _read_counts()
            paths[f"case study {name}"] = launches
            g = _case_record(res, secs, stages, choice)
            need = ["fused_mix_mh_rounds", "chunk_draws"]
            if choice is not None:
                need.append("chol_quadratics_lanes")
            _require_launched(launches, need, f"{name} study")
            n_rows = 0 if choice is None else len(choice.likelihoods)
            if launches["chol_quadratics_lanes"] < n_rows:
                raise AssertionError(f"{name}: fewer K3 launches than grid "
                                     f"rows")
            mc = res.fit.mcmc
            eb = (f"EB row {int(choice.index)} {choice.pars.tolist()} of "
                  f"{n_rows}; " if choice is not None else "")
            log(f"[19] {name} on the GPU (K=4, f64, full budget): {secs:.1f} "
                f"s ({_stage_line(g)}); {eb}chain {mc.n_recorded} / "
                f"{mc.n_proposals} / {mc.n_rounds}, chain_ok="
                f"{res.fit.chain_ok}; {_summary_line(res)}; launches="
                f"{launches}")
            if not res.fit.chain_ok:
                raise AssertionError(f"{name}: chain unhealthy")
            if not all(math.isfinite(v) for v in res.summary.rmspe.values()):
                raise AssertionError(f"{name}: non-finite RMSPE")
            rows = list(range(n_rows))
            if name == "heat_exchanger":
                best = torch.argsort(choice.likelihoods.cpu(),
                                     descending=True)[:HEAT_CPU_ROWS]
                rows = sorted(set(best.tolist()) | set(range(0, n_rows, 48)))
                eb_row = int(choice.index)
                cpu_root = tmp / "cpu"
                gv_data_root(cpu_root)
                standin_data_root(cpu_root, heat_rows=rows)
                _data_root(cpu_root)
            if name == "ground_vibrations":
                z_gv = mc.laplace.mode.cpu().tolist()
            c = (twins.get(name) if twins is not None and name in TWINS
                 else _case_record(*run_case(name, "cpu")[:4]))
            _data_root(tmp)
            gpu_s, cpu_s = gpu_s + g["secs"], cpu_s + c["secs"]
            err, eb_err = _compare_case(name, g, c,
                                        rows if choice is not None else None)
            same = ""
            if choice is not None:
                same_err = _eb_same_inputs(name, choice, call, rows)
                same = (f"; EB on the same inputs {same_err:.3g} (tol "
                        f"{EB_RTOL:g}), the two studies' scans {eb_err:.3g} "
                        f"over {len(rows)} of the {n_rows} rows")
            log(f"[19] {name}: GPU == CPU (chain {g['chain'][:3]}, largest "
                f"rel err {err:.3g}, tol {STUDY_RTOL:g}{same}); CPU "
                f"{c['secs']:.1f} s ({_stage_line(c)})")
        gv_serialize(golden, tmp)
        times = new_shape_kernels(z_gv, eb_row)
        log(f"[19] the studies {gpu_s:.1f} s on the GPU, {cpu_s:.1f} s on "
            f"the CPU (host clock)")
        return paths, times
    finally:
        from ccgp_tpu_torch.eval import datasets

        datasets._DEFAULT_ROOTS = before
        shutil.rmtree(tmp, ignore_errors=True)


# each counted wrapper's kernels, by the demangled name the profiler gives
# them: a name is the wrapper's when it holds every substring of one of
# the wrapper's patterns
_SYMBOLS = {"geweke_pvalue": (("geweke_kernel<",),),
            "threefry_split_chain": (("split_chain_kernel",),),
            "chunk_draws": (("chunk_draws_kernel<",),),
            "chunk_draws_lanes": (("chunk_draws_lanes_kernel<",),),
            "fused_mix_mh_rounds": (("mh_rounds_kernel<",),),
            # K3 and K4 share two kernels, the factor output a flag
            "chol_quadratics_lanes": (("lanes_warp_kernel<", ", false>"),
                                      ("lanes_tiles_kernel<", ", false>")),
            "chol_factors_lanes": (("lanes_warp_kernel<", ", true>"),
                                   ("lanes_tiles_kernel<", ", true>")),
            # K5 and K6 share two kernels templated on the entries' source
            "chol_quadratics_smallk": (("chol_quad_tiles_kernel<",
                                        "GramSource<"),
                                       ("chol_quad_panel_kernel<",
                                        "GramSource<")),
            "fused_mix_quadratics_smallk": (("chol_quad_tiles_kernel<",
                                             "SeMixSource<"),
                                            ("chol_quad_panel_kernel<",
                                             "SeMixSource<")),
            "fused_mix_mh_round": (("mh_round_cluster_kernel<",),
                                   ("smallk_kernel<",)),
            "fused_mix_quadratics": (("gram_chol_kernel<",),),
            "chol_nll": (("chol_nll_kernel<",),)}


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
    return any(all(s in name for s in pat) for pat in _SYMBOLS[wrapper])


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


def _library_ms(fn, reps, call_ms, tries=3):
    """(ms, how) for a library route: its device time per call under the
    profiler when no record was lost (`_lost`), in one of `tries` windows;
    else the CUDA-event time per call `call_ms`."""
    for _ in range(tries):
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
    return _bound(nbytes, (ops, PEAK_OPS[elem]))


def _bound(nbytes, *work):
    """(ms, what bounds it): the bytes over the memory rate against the
    sum over `work`'s (operations, peak rate) pairs."""
    tb, to = nbytes / HBM_BPS, sum(ops / peak for ops, peak in work)
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
    covariances (B = 1728, n = 14, f64), the lazy predict's first chunk
    (B = 64 draws of the bench chain, n = 100, f32) and the 1-D fit's
    factor cache (B = 200, the --fast budget's retained draws, n = 8,
    f64, jitter 0 as the 1-D fit has it; SE Grams stand in for the
    chain's Matern mixtures, which need a 1-D fit first)."""
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
    g1, y1 = se_grams(FAST_1D["net_samp_size"], 8, seed=8)
    grams["factor_cache_1d"] = torch.tensor(g1, device="cuda")
    ys["factor_cache_1d"] = torch.tensor(y1, device="cuda")
    jit = {"map_cloud": 1e-3, "map_zoom": 1e-3, "lazy_chunk": 1e-3,
           "eb_row": 0.0, "factor_cache_1d": 0.0}
    return grams, ys, jit


# (shape, K3 or K4) of phase 6's lanes timings
LANES_TIMED = (("map_cloud", False), ("map_zoom", False), ("eb_row", False),
               ("lazy_chunk", True), ("factor_cache_1d", True))


def _lanes_timing(fit):
    """K3 and K4 at `_lanes_inputs`' shapes: device and per-call time, the
    path the layout gives each shape, the plain twin's time per call, the
    library route (cholesky_ex + solve_triangular of [y, 1], timed only)
    and the bound."""
    from ccgp_tpu_torch.ops import chol_lanes

    out = {}
    grams, ys, jit = _lanes_inputs(fit)
    for name, factors in LANES_TIMED:
        kern, plain = ((chol_lanes.chol_factors_lanes,
                        chol_lanes.chol_factors_lanes_plain) if factors else
                       (chol_lanes.chol_quadratics_lanes,
                        chol_lanes.chol_quadratics_lanes_plain))
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
        group, threads, blocks = chol_lanes.lanes_layout(n, b, g.dtype)
        path = (f"warp path, {group} lanes per matrix" if group
                else "tile path") + f", {blocks} blocks of {threads}"
        log(f"[6] {kern.__name__} {name} B={b} n={n} {g.dtype} ({path}): "
            f"kernel {k:.4f} ms {how} ({call:.4f} ms per call), plain "
            f"{p:.3f} ms per call, cholesky_ex+solve_triangular {lib:.4f} "
            f"ms {lib_how} ({lib_call:.4f} ms per call), bound "
            f"{bound[0]:.2e} ms ({bound[1]})")
        out[(kern.__name__, name)] = (k, p, lib, bound)
    return out


# K2's work per threefry block on the card: 20 rounds of an add, a rotate
# (one funnel shift) and an xor, 5 key injections of three adds, the key
# schedule's xor and the two first adds; the unit float's shift, or and
# subtraction. A normal adds its scale, shift and clamp and an erfinv, a
# log-uniform its log: erfinv counted as 30 operations and log as 20 (the
# CUDA math library's polynomial and range reduction), in the draw's type
THREEFRY_OPS = 80
ERFINV_OPS, LOG_OPS = 30, 20


def _k2_bound(rr, kk, dim, elem):
    """(ms, what bounds it) for rr rounds of keys and draws: the key read
    and the new key, eps and log_u written once; the threefry blocks (3 per
    split, one per draw) at the int32 rate and the floating-point work at
    the vector rate of the type."""
    draws = rr * kk * dim + rr * kk
    nbytes = 16 + 16 + elem * draws
    ints = THREEFRY_OPS * (3 * rr + draws) + 3 * draws
    floats = rr * kk * dim * (4 + ERFINV_OPS) + rr * kk * (2 + LOG_OPS)
    return _bound(nbytes, (ints, PEAK_OPS["int32"]), (floats, PEAK_VEC[elem]))


_LATENCY_SRC = r"""
// One thread, a chain of dependent 32-bit integer operations as threefry's
// rounds have them (y = rotl(y) ^ (x += y): an add, then an xor that waits
// for it; the rotate runs beside the add), timed by clock64.
#include <cuda_runtime.h>
__global__ void dep_loop(unsigned a, unsigned b, long long* out,
                         unsigned* sink, int iters) {
  unsigned x = a, y = b;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x += y;
      y = __funnelshift_l(y, y, 13) ^ x;
    }
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  sink[0] = x ^ y;
}
extern "C" int ccgp_dep_latency(void* out, void* sink, int iters,
                                void* stream) {
  dep_loop<<<1, 1, 0, (cudaStream_t)stream>>>(1u, 2u, (long long*)out,
                                              (unsigned*)sink, iters);
  return (int)cudaGetLastError();
}
// One thread, a chain of dependent floating-point adds (explicitly rounded,
// as csrc/geweke.cu's), timed by clock64.
template <typename T> __device__ T addr(T a, T b);
template <> __device__ float addr(float a, float b) { return __fadd_rn(a, b); }
template <> __device__ double addr(double a, double b) { return __dadd_rn(a, b); }
template <typename T>
__global__ void fadd_loop(T a, T b, long long* out, T* sink, int iters) {
  T x = a;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) x = addr(x, b);
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  sink[0] = x;
}
extern "C" int ccgp_fadd_latency(void* out, void* sink, int iters, int f64,
                                 void* stream) {
  if (f64)
    fadd_loop<double><<<1, 1, 0, (cudaStream_t)stream>>>(
        1.0, 1e-9, (long long*)out, (double*)sink, iters);
  else
    fadd_loop<float><<<1, 1, 0, (cudaStream_t)stream>>>(
        1.0f, 1e-9f, (long long*)out, (float*)sink, iters);
  return (int)cudaGetLastError();
}
"""


@functools.cache
def _latency_lib():
    """`_LATENCY_SRC` built with the package's nvcc flags, once a process."""
    import ctypes

    from ccgp_tpu_torch.ops import _build

    src = _build.BUILD_DIR / "sweep" / "dep_latency.cu"
    out = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(_LATENCY_SRC)
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(out), str(src)]])
    lib = ctypes.CDLL(str(out))
    lib.ccgp_dep_latency.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.ccgp_fadd_latency.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def _loop_cycles(launch, sink_dtype, steps):
    """The fewest cycles per step of five runs of one of `_LATENCY_SRC`'s
    clock64 loops: launch(cycles, sink, stream) runs it, `steps` dependent
    steps in all."""
    from ccgp_tpu_torch.ops import _build

    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=sink_dtype, device="cuda")
    best = math.inf
    for _ in range(5):
        _build.check(launch(cyc.data_ptr(), sink.data_ptr(),
                            _build.stream(cyc.device)), "latency loop")
        torch.cuda.synchronize()
        best = min(best, int(cyc.item()) / steps)
    return best


def dependent_issue_cycles(iters=4096):
    """Not a phase: the card's latency of one dependent 32-bit integer
    operation, in cycles, from a clock64 loop of iters x 16 steps of two
    dependent operations (`_LATENCY_SRC`)."""
    lib = _latency_lib()
    return _loop_cycles(lambda c, s, st: lib.ccgp_dep_latency(c, s, iters, st),
                        torch.int32, iters * 16 * 2)


def dependent_fadd_cycles(dtype, iters=4096):
    """Not a phase: the card's latency of one dependent floating-point add
    of `dtype`, in cycles, from a clock64 loop of iters x 16 adds
    (`_LATENCY_SRC`)."""
    lib = _latency_lib()
    f64 = int(dtype == torch.float64)
    return _loop_cycles(
        lambda c, s, st: lib.ccgp_fadd_latency(c, s, iters, f64, st),
        dtype, iters * 16)


def chain_sass_depth():
    """Not a phase: the dependent instructions on the critical path of one
    split in `chunk_draws_kernel<float, int>`'s chain loop, read from
    `cuobjdump -sass` of csrc/threefry_split_chain.cu built with the
    package's flags. The loop (not unrolled) is the innermost one around
    the store of the round's keys to shared memory (STS.128); each
    instruction's depth is one more than its deepest source register's
    within the body, and the registers the body does not write (the carry,
    the constants) are depth 0. Returns (depth, instructions in the body)."""
    import re
    import shutil
    import tempfile

    from ccgp_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(
        __import__("pathlib").Path(nvcc).parent / "cuobjdump")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cubin = f"{tmp}/k2.cubin"
        _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", cubin,
                          str(_build.SRC_DIR / "threefry_split_chain.cu")]])
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    func = None
    body = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            continue
        if func and "chunk_draws_kernelIfiE" in func:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2).strip()))
    if not body:
        raise RuntimeError("chain_sass_depth: chunk_draws_kernel<float, "
                           "int> not found in the SASS")
    sts = [a for a, ins in body if "STS.128" in ins]
    loops = []
    for a, ins in body:
        m = re.search(r"BRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < a:
            lo = int(m.group(1), 16)
            if any(lo <= x <= a for x in sts):
                loops.append((a - lo, lo, a))
    if not loops:
        raise RuntimeError("chain_sass_depth: no loop around the key store")
    _, lo, hi = min(loops)
    depth, deepest, count = {}, 0, 0
    for a, ins in body:
        if not lo <= a <= hi:
            continue
        ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
        op, _, rest = ins.partition(" ")
        args = [a.strip() for a in rest.split(",")]
        dest = re.fullmatch(r"(U?R\d+)(\.reuse)?", args[0]) if args else None
        if dest is None or op.startswith(("ST", "BRA", "BAR", "RED", "ATOM")):
            continue
        srcs = re.findall(r"\bU?R\d+\b", ",".join(args[1:]))
        d = 1 + max([depth.get(r, 0) for r in srcs], default=0)
        depth[dest.group(1)] = d
        deepest = max(deepest, d)
        count += 1
    return deepest, count


def _sm_clock_mhz():
    """nvidia-smi's SM clock read while a spin kernel keeps the card busy,
    and its maximum."""
    torch.cuda._sleep(3_000_000_000)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    now, top = (float(v) for v in smi.split(","))
    return now, top


def k2_serial_floor():
    """(ms per split, how it was read): the chain's dependent instructions
    per split (`chain_sass_depth`) x the latency of a dependent operation
    (`dependent_issue_cycles`) at the SM clock nvidia-smi reads under load.
    rr dependent splits take at least rr times this. Run it alone with
    python3 -c 'import chip_smoke as s; s.phase_device(); s.phase_build();
    print(s.k2_serial_floor())'."""
    depth, count = chain_sass_depth()
    cycles = dependent_issue_cycles()
    mhz, top = _sm_clock_mhz()
    return depth * cycles / (mhz * 1e3), (
        f"{depth} dependent instructions per split (of {count} in the loop "
        f"body, cuobjdump -sass) x {cycles:.2f} cycles each (clock64 loop) "
        f"at {mhz:g} MHz (nvidia-smi under load; max {top:g})")


K2_TIMED = (("bench", 120, 4, 4, torch.float32),
            ("bench", 20, 4, 4, torch.float32),
            ("1-D round", 1, 4, 1, torch.float64))


def _k2_timing():
    """K2 at the paths' shapes: the fused kernel (device and per-call time),
    its plain version per call, the split chain alone (the kernel before
    the draws were fused in), and the plain draws the kernel replaced on
    the card, per chunk, in host wall time and in device time; the two
    bounds: the roofline over the fused work and the chain's serial
    floor."""
    from ccgp_tpu_torch.ops import rng

    out = {}
    key = rng.PRNGKey(7, device="cuda")
    per_split, floor_how = k2_serial_floor()
    for label, rr, kk, dim, dtype in K2_TIMED:
        fn = lambda: rng.chunk_draws(key, rr, kk, dim, dtype)  # noqa: E731
        call = _cuda_ms(fn, 50)
        k, how = _kernel_ms("chunk_draws", fn, 50, call)
        p = _cuda_ms(lambda: rng.chunk_draws_plain(key, rr, kk, dim, dtype), 3)
        chain = lambda: rng.threefry_split_chain(key, rr)  # noqa: E731
        ck, chow = _kernel_ms("threefry_split_chain", chain, 50,
                              _cuda_ms(chain, 50))
        _, k1s, k2s = rng.threefry_split_chain(key, rr)
        if rr > 1:   # the chunked driver's draws after the chain kernel
            replaced = lambda: (rng.normal(k1s, (kk, dim), dtype),  # noqa: E731
                                torch.log(rng.uniform(k2s, (kk,), dtype)))
        else:        # a one-round body's split and draws
            def replaced():
                ch = rng.split(key, 3)
                return (rng.normal(ch[1], (kk, dim), dtype),
                        torch.log(rng.uniform(ch[2], (kk,), dtype)))
        replaced()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            replaced()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 20
        by_name, _ = _device_profile(replaced, 5)
        busy = sum(v[0] for v in by_name.values())
        nk = sum(v[1] for v in by_name.values()) / 5
        bound = _k2_bound(rr, kk, dim, torch.finfo(dtype).bits // 8)
        floor = rr * per_split
        log(f"[6] chunk_draws {label} rr={rr} K={kk} dim={dim} {dtype}: "
            f"kernel {k:.4f} ms {how} ({call:.4f} ms per call); the split "
            f"chain alone {ck:.4f} ms {chow}; plain {p:.3f} ms per call; the "
            f"plain draws it replaced {wall:.4f} ms per chunk of host wall "
            f"time, {busy:.4f} ms of device time in {nk:g} kernels; bounds: "
            f"roofline {bound[0]:.2e} ms ({bound[1]}), serial floor "
            f"{floor:.4f} ms ({floor_how}); the {'serial floor' if floor > bound[0] else 'roofline'} bounds")
        out[("chunk_draws", rr)] = (k, p, None, bound)
        out[("chunk_draws floor", rr)] = floor
    return out


K2_LANES = 100   # the sweep's lanes: its 100 designs


def _k2_lanes_timing(floor):
    """K2's lanes launch at the sweep's shape (L = 100 lanes, rr = 120,
    K = 1, dim = 3) in f32 and f64: device and per-call time, the L single
    `chunk_draws` launches it replaces (their device time and their time
    per call), its plain version per call. Its bound is one lane's serial
    floor `floor` (the lanes run side by side: 100 blocks fit on the card
    at once), beside the roofline over all lanes' work."""
    from ccgp_tpu_torch.ops import rng

    out = {}
    keys = rng.split(rng.PRNGKey(7, device="cuda"), K2_LANES)
    for dtype in (torch.float32, torch.float64):
        fn = lambda: rng.chunk_draws_lanes(keys, 120, 1, 3, dtype)  # noqa: E731
        call = _cuda_ms(fn, 50)
        k, how = _kernel_ms("chunk_draws_lanes", fn, 50, call)
        singles = lambda: [rng.chunk_draws(keys[i], 120, 1, 3, dtype)  # noqa: E731
                           for i in range(K2_LANES)]
        s_call = _cuda_ms(singles, 5)
        by_name, launched = _device_profile(singles, 3)
        s_dev, seen = _of_kernel("chunk_draws", by_name)
        s_how = ("on the device" if seen == launched["chunk_draws"]
                 else f"profiler kept {seen} of {launched['chunk_draws']} "
                      "records")
        p = _cuda_ms(lambda: rng.chunk_draws_lanes_plain(keys, 120, 1, 3,
                                                         dtype), 1)
        elem = torch.finfo(dtype).bits // 8
        roof = _k2_bound(120 * K2_LANES, 1, 3, elem)
        log(f"[6] chunk_draws_lanes L={K2_LANES} rr=120 K=1 dim=3 {dtype}: "
            f"kernel {k:.4f} ms {how} ({call:.4f} ms per call); {K2_LANES} "
            f"single chunk_draws launches {s_dev:.4f} ms of device time "
            f"({s_how}), {s_call:.4f} ms per call; plain {p:.1f} ms per "
            f"call; bound: one lane's serial floor {floor:.4f} ms (roofline "
            f"over the {K2_LANES} lanes {roof[0]:.2e} ms, {roof[1]})")
        out[("chunk_draws_lanes", dtype)] = (k, p, None, (floor, "serial"))
        out[("chunk_draws_lanes singles", dtype)] = (s_dev, s_call)
    return out


def phase_timing(fit):
    from ccgp_tpu_torch.models.combination import mixed_gram, unpack
    from ccgp_tpu_torch.ops import chol_smallk

    out = _k2_timing()
    out.update(_k2_lanes_timing(out[("chunk_draws floor", 120)]))
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
        bound = _bound(nbytes, (rr * kk * n * (n + 1) / 2 * (5 * d + 6),
                                PEAK_VEC[4]),
                       (rr * kk * (n ** 3 / 3 + 2 * n * n), PEAK_OPS[4]))
        log(f"[6] fused_mix_mh_rounds n=100 K=4 R={rr} f32 stash: kernel "
            f"{k:.3f} ms {how} ({1e3 * k / rr:.1f} us/round; "
            f"{call:.3f} ms per call) on a cluster of "
            f"{chol_smallk.rounds_layout(n, kk)[0]} SMs, plain {p:.1f} ms per "
            f"call, cholesky_ex x R {lib:.4f} ms {lib_how} ({lib_call:.3f} "
            f"ms per call), bound {bound[0]:.2e} ms ({bound[1]})")
        out[("fused_mix_mh_rounds", rr)] = (k, p, lib, bound)
    out.update(_lanes_timing(fit))
    out.update(_smallk_timing())
    out.update(_k8_k9_timing())
    return out


# --- phase 23: Geweke's p-value on the card (csrc/geweke.cu) ---------------

# the fit cells' windows: samp_size 1000 rows of the chain's state, dim 4 in
# f32 (bench2d.n100) and dim 3 in f64 (gv9d.splits)
GEWEKE_SHAPES = (("bench2d.n100", 4, torch.float32),
                 ("gv9d.splits", 3, torch.float64))
GEWEKE_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}

def geweke_depth(n, dim):
    """The dependent floating-point operations on the critical path of one
    window's p-value, with every sum taken as a balanced tree: per part
    the mean (log2 m adds, a divide), the centring, an autocovariance (a
    multiply, log2 m adds, a divide), then per order k of the recursion a
    product and log2(k - 1) adds for acc, a subtract, a divide, the update
    of phi (a multiply, a subtract) and log2 k adds for s; the AIC scan
    (a multiply, log, an add, log2(km + 1) compares), spec0 (four); then z
    (a divide, an add, a square root, a subtract, a divide), the p-value
    (five) and log2 dim compares. The longer part sets the depth: the two
    parts run side by side."""
    from ccgp_tpu_torch.ops.geweke import layout

    lg = lambda v: math.ceil(math.log2(v)) if v > 1 else 0  # noqa: E731
    _, n2, _, km, _, _ = layout(n, dim, 8)
    depth = (lg(n2) + 1) + 1 + (1 + lg(n2) + 1)
    depth += sum(1 + lg(k - 1) + 1 + 1 + 2 + lg(k) for k in range(1, km + 1))
    depth += 3 + lg(km + 1) + 4
    return depth + 5 + 5 + lg(dim)


def _ar1(n, dim, rho, seed):
    r = np.random.default_rng(seed)
    e = r.normal(size=(n, dim))
    x = np.zeros((n, dim))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + e[i]
    return x


def phase_geweke():
    """Geweke's kernel at the fit cells' shapes (n = 1000; dim 4 in f32,
    dim 3 in f64): AR(1) windows (rho 0, 0.6, 0.95; 4 seeds each) read in
    place from chain buffers of rows dim + 2, against the plain path as
    the drivers took it before (the window read back, the p-value on the
    CPU): within 1e-12 relative (f64) or 1e-4 (f32) and the same decision
    against 0.5 away from it. Then timed: the kernel's device and per-call
    time; a check as the drivers make it on the card (the launch and the
    p-value's read-back, host clock); the plain version on the card
    (`infer.geweke.geweke_pvalue` of the CUDA window, CUDA events) and on
    the CPU path it replaced (the window's read-back and the CPU's
    p-value, host clock); the bounds: the roofline (the two parts' values
    read once) and the serial floor (`geweke_depth` dependent operations x
    one dependent add's latency at the SM clock under load)."""
    from ccgp_tpu_torch.infer.geweke import geweke_pvalue as plain
    from ccgp_tpu_torch.ops import geweke

    out, errs = {}, {}
    mhz, _ = _sm_clock_mhz()
    for label, dim, dtype in GEWEKE_SHAPES:
        worst, agree = 0.0, 0
        for rho in (0.0, 0.6, 0.95):
            for seed in range(4):
                P = torch.tensor(_ar1(1300, dim + 2, rho, 100 * dim + seed),
                                 dtype=dtype, device="cuda")
                w = P[150:1150, :dim]
                got = float(geweke.geweke_pvalue(w))
                ref = float(plain(w.cpu()))
                err = abs(got - ref) / (abs(ref) if dtype == torch.float64
                                        else 1.0)
                worst = max(worst, err)
                agree += got == ref
                if not err <= GEWEKE_TOL[dtype]:
                    raise AssertionError(f"[23] geweke {label} rho={rho} "
                                         f"seed={seed}: {got} against {ref}")
                if abs(ref - 0.5) > 1e-4 and (got >= 0.5) != (ref >= 0.5):
                    raise AssertionError(f"[23] geweke {label}: the decision"
                                         f" moved ({got} against {ref})")
        errs[label] = worst
        P = torch.tensor(_ar1(1300, dim + 2, 0.6, 7), dtype=dtype,
                         device="cuda")
        w = P[150:1150, :dim]
        fn = lambda: geweke.geweke_pvalue(w)  # noqa: E731
        call = _cuda_ms(fn, 200)
        k, how = _kernel_ms("geweke_pvalue", fn, 50, call)
        fn().item()
        t0 = time.perf_counter()
        for _ in range(200):
            fn().item()
        check = (time.perf_counter() - t0) * 1e3 / 200
        p_card = _cuda_ms(lambda: plain(w), 5)
        float(plain(w.cpu()))
        t0 = time.perf_counter()
        for _ in range(20):
            float(plain(w.cpu()))
        p_cpu = (time.perf_counter() - t0) * 1e3 / 20
        elem = torch.finfo(dtype).bits // 8
        n1, n2, km1, km2, warps, smem = geweke.layout(1000, dim, elem)
        # per part and column: the mean and the centring, the lags'
        # products and sums, the recursion's ~4 km^2
        ops = sum(dim * (2 * m + 2 * m * (km + 1) + 4 * km * km)
                  for m, km in ((n1, km1), (n2, km2)))
        roof = _bound(elem * ((n1 + n2) * dim + 1), (ops, PEAK_OPS[elem]))
        depth = geweke_depth(1000, dim)
        cycles = dependent_fadd_cycles(dtype)
        floor = depth * cycles / (mhz * 1e3)
        log(f"[23] geweke_pvalue {label} n=1000 dim={dim} {dtype}: kernel "
            f"{k:.4f} ms {how} ({call:.4f} ms per call; {warps} warps, "
            f"{smem} B of shared memory); a check on the card (launch and "
            f"read-back) {check:.4f} ms; plain on the card {p_card:.3f} ms "
            f"per call; the CPU path it replaced (read-back and CPU p-value) "
            f"{p_cpu:.3f} ms per check; bounds: roofline {roof[0]:.2e} ms "
            f"({roof[1]}), serial floor {floor:.4f} ms ({depth} dependent "
            f"operations x {cycles:.2f} cycles at {mhz:g} MHz); max "
            f"{'relative' if dtype == torch.float64 else 'absolute'} error "
            f"{worst:.2e}, {agree} of 12 p-values equal")
        out[("geweke_pvalue", label)] = (k, p_card, None, (floor, "serial"))
        out[("geweke_pvalue extra", label)] = dict(
            call_ms=call, check_ms=check, cpu_path_ms=p_cpu,
            roofline_ms=roof[0])
    return out, errs


def _geweke_record(launches, errs, times):
    """The Geweke kernel's record at the GV cell's shape (f64), the bench
    cell's (f32) beside it: `bound_ms` its serial floor, which bounds;
    `cpu_path_ms` the read-back and CPU p-value it replaced, per check."""
    rec = _record("geweke_pvalue", "ccgp_tpu_torch/csrc/geweke.cu",
                  "none (ccgp_tpu/infer/geweke.py runs as XLA ops)",
                  launches, errs["gv9d.splits"],
                  times[("geweke_pvalue", "gv9d.splits")])
    extra = times[("geweke_pvalue extra", "gv9d.splits")]
    rec.update(bound="serial_floor", **extra,
               ms_f32=times[("geweke_pvalue", "bench2d.n100")][0],
               max_abs_err_f32=errs["bench2d.n100"])
    return rec


def _smallk_timing():
    """K5 at the 1-D round's shape (K = 4, n = 8, f64) and at n = 100, 256,
    512 and 1024 (K = 4, f32); K6 and K7 at the bench's one-round shape
    (K = 4, n = 100, d = 2, f32) and K6 at n = 256. Each: device and
    per-call time, the plain twin's time per call, the library route
    (cholesky_ex + solve_triangular of [y, 1] on the same K Grams, timed
    only) and the bound."""
    from ccgp_tpu_torch.ops import chol_smallk

    out = {}
    for label, kk, n, dtype, j in (("1-D round", 4, 8, torch.float64, 1e-6),
                                   ("n=100", 4, 100, torch.float32, 1e-3),
                                   ("n=256", 4, 256, torch.float32, 1e-3),
                                   ("n=512", 4, 512, torch.float32, 1e-3),
                                   ("n=1024", 4, 1024, torch.float32, 1e-3)):
        g, y = (torch.tensor(a, dtype=dtype, device="cuda")
                for a in se_grams(kk, n, seed=n))
        fn = lambda: chol_smallk.chol_quadratics_smallk(g, y, jitter=j)  # noqa: E731
        call = _cuda_ms(fn, 20)
        k, how = _kernel_ms("chol_quadratics_smallk", fn, 20, call)
        p = _cuda_ms(lambda: chol_smallk.chol_quadratics_smallk_plain(
            g, y, jitter=j), 3)
        lib_fn = lambda: _library_lanes(g, y, j)  # noqa: E731
        lib_call = _cuda_ms(lib_fn, 20)
        lib, lib_how = _library_ms(lib_fn, 20, lib_call)
        bound = _lanes_bound(kk, n, g.element_size(), False)
        cluster, blocks, _ = chol_smallk.smallk_layout(
            "chol_quadratics_smallk", n, kk, dtype)
        log(f"[6] chol_quadratics_smallk {label} K={kk} n={n} {dtype} "
            f"({blocks} blocks, clusters of {cluster}): "
            f"kernel {k:.4f} ms {how} ({call:.4f} ms per call), plain "
            f"{p:.3f} ms per call, cholesky_ex+solve_triangular {lib:.4f} "
            f"ms {lib_how} ({lib_call:.4f} ms per call), bound "
            f"{bound[0]:.2e} ms ({bound[1]})")
        out[("chol_quadratics_smallk", label)] = (k, p, lib, bound)
    # K6 and K7 at the bench's one-round shape; K6 also at n = 256, the
    # edge of the gate that sends it the body_spec rounds (its panel core)
    for name, n in (("fused_mix_quadratics_smallk", 100),
                    ("fused_mix_mh_round", 100),
                    ("fused_mix_quadratics_smallk", 256)):
        kk, d, elem = 4, 2, 4
        dim = d + 2
        args, rnd = mix_case(kk, n, d, torch.float32, seed=7)
        args["jitter"] = 1e-3
        grams = chol_smallk._se_mix_gram_plain(args["x"], args["r1"],
                                               args["r2"], args["p"], 0.0)
        lib_fn = lambda: _library_lanes(grams, args["y"], 1e-3)  # noqa: E731
        lib_call = _cuda_ms(lib_fn, 20)
        lib, lib_how = _library_ms(lib_fn, 20, lib_call)
        # x, y, the rates and weights in; four quadratics per member out
        nbytes = elem * (n * d + n + 2 * kk * d + kk + 4 * kk)
        gram = kk * n * (n + 1) / 2 * (5 * d + 6)
        fact = kk * (n ** 3 / 3 + 2 * n * n + 6 * n)
        if name == "fused_mix_mh_round":
            # plus extra, log_scale, log_u, the candidates and the state in;
            # z_new, [val, beta] and two int32 flags out (the quadratics stay
            # inside); the log-posteriors
            nbytes += (elem * (-4 * kk + 3 * kk + kk * dim + 2 + dim + 2)
                       + 8)
            gram += 12 * kk
            fn = lambda: chol_smallk.fused_mix_mh_round(**args, **rnd)  # noqa: E731
            plain = lambda: chol_smallk.fused_mix_mh_round_plain(  # noqa: E731
                **args, **rnd)
        else:
            fn = lambda: chol_smallk.fused_mix_quadratics_smallk(**args)  # noqa: E731
            plain = lambda: chol_smallk.fused_mix_quadratics_smallk_plain(  # noqa: E731
                **args)
        call = _cuda_ms(fn, 20)
        k, how = _kernel_ms(name, fn, 20, call)
        p = _cuda_ms(plain, 3)
        bound = _bound(nbytes, (gram, PEAK_VEC[elem]), (fact, PEAK_OPS[elem]))
        cluster, blocks, _ = chol_smallk.smallk_layout(name, n, kk,
                                                       torch.float32)
        log(f"[6] {name} K={kk} n={n} d={d} f32 ({blocks} blocks, clusters "
            f"of {cluster}): kernel {k:.4f} ms {how} "
            f"({call:.4f} ms per call), plain {p:.3f} ms per call, "
            f"cholesky_ex+solve_triangular of the same Grams {lib:.4f} ms "
            f"{lib_how} ({lib_call:.4f} ms per call), bound "
            f"{bound[0]:.2e} ms ({bound[1]})")
        out[(name, f"n={n}")] = (k, p, lib, bound)
    return out


def _k8_k9_timing():
    """K8 at the EB row and at the MAP cloud, K9 at the MAP cloud and at
    B = 128 SE Grams, n = 128, f64: device
    and per-call time, the plain twin's time per call, the library route
    (the Grams built in torch, then cholesky_ex + solve_triangular of
    [y, 1]; timed only) and the bound."""
    from ccgp_tpu_torch.ops import chol_nll, gram_chol

    out = {}
    eb, eb_cov = eb_row_inputs()
    mp, map_grams = map_cloud_inputs()
    # K8's library route builds its covariances in torch first
    map_lib = lambda: _library_lanes(map_grams(), mp["y"], 1e-3)  # noqa: E731
    eb_lib = lambda: _library_lanes(eb_cov(), eb["y"], 0.0)  # noqa: E731
    for label, args, jit, lib_fn in (("eb_row", eb, 0.0, eb_lib),
                                     ("map_cloud", mp, 1e-3, map_lib)):
        fn = lambda: gram_chol.fused_mix_quadratics(**args, jitter=jit)  # noqa: E731
        call = _cuda_ms(fn, 20)
        k, how = _kernel_ms("fused_mix_quadratics", fn, 20, call)
        p = _cuda_ms(lambda: gram_chol.fused_mix_quadratics_plain(
            **args, jitter=jit), 3)
        lib_call = _cuda_ms(lib_fn, 5)
        lib, lib_how = _library_ms(lib_fn, 5, lib_call)
        (n, d), b = args["x"].shape, args["r1"].shape[0]
        elem = args["x"].element_size()
        # x, y, two rates per axis, p, scale and shift per lane in; four
        # quadratics per lane out; the Gram build (two exp and ~5 d + 8
        # operations per entry of the upper triangle, elementwise) and the
        # factorization with its solves (multiply-adds)
        nbytes = elem * (n * d + n + b * (2 * d + 3) + 4 * b)
        bound = _bound(nbytes,
                       (b * n * (n + 1) / 2 * (5 * d + 8), PEAK_VEC[elem]),
                       (b * (n ** 3 / 3 + 2 * n * n + 6 * n), PEAK_OPS[elem]))
        log(f"[6] fused_mix_quadratics {label} B={b} n={n} d={d} "
            f"{args['x'].dtype}: kernel {k:.4f} ms {how} ({call:.4f} ms per "
            f"call), plain {p:.3f} ms per call, Grams + cholesky_ex + "
            f"solve_triangular {lib:.4f} ms {lib_how} ({lib_call:.4f} ms per "
            f"call), bound {bound[0]:.2e} ms ({bound[1]})")
        out[("fused_mix_quadratics", label)] = (k, p, lib, bound)
    # K8 is latency-bound, a pivot step per block at a time: the EB row's
    # lanes at one per SM (132), as the row runs them (1728, ~13 per SM)
    # and four times as many. Flat times say the block's own steps, not
    # launching and scheduling the blocks, take the time
    lanes = []
    for b in (132, 1728, 4 * 1728):
        idx = torch.arange(b, device="cuda") % 1728
        args = dict(eb, r1=eb["r1"][idx].contiguous(),
                    r2=eb["r2"][idx].contiguous(), p=eb["p"][idx],
                    scale=eb["scale"][idx])
        fn = lambda: gram_chol.fused_mix_quadratics(**args)  # noqa: E731
        k, how = _kernel_ms("fused_mix_quadratics", fn, 20, _cuda_ms(fn, 20))
        lanes.append(f"B={b} {k:.4f} ms {how}")
    log(f"[6] fused_mix_quadratics at the EB row's n = 14, f64, by lanes: "
        + "; ".join(lanes))
    # K9 at the MAP cloud (the kernel record's shape) and at B = 128 SE
    # Grams, n = 128, f64 (`_k9_cases`)
    for (label, g, y, jit), tag in zip(_k9_cases(), ("map_cloud", "f64")):
        fn = lambda: chol_nll.chol_nll(g, y, jitter=jit)  # noqa: E731
        call = _cuda_ms(fn, 20)
        k, how = _kernel_ms("chol_nll", fn, 20, call)
        p = _cuda_ms(lambda: chol_nll.chol_nll_plain(g, y, jitter=jit), 3)
        lib_fn = lambda: _library_lanes(g, y, jit)  # noqa: E731
        lib_call = _cuda_ms(lib_fn, 20)
        lib, lib_how = _library_ms(lib_fn, 20, lib_call)
        bound = _lanes_bound(g.shape[0], g.shape[-1], g.element_size(),
                             False)
        log(f"[6] chol_nll {label}: kernel {k:.4f} ms {how} ({call:.4f} ms "
            f"per call), plain {p:.3f} ms per call, cholesky_ex + "
            f"solve_triangular {lib:.4f} ms {lib_how} ({lib_call:.4f} ms per "
            f"call), bound {bound[0]:.2e} ms ({bound[1]})")
        out[("chol_nll", tag)] = (k, p, lib, bound)
    return out


# ---------------------------------------------------------------------------
# the multi-design sweep and the parallel surface
# ---------------------------------------------------------------------------

SWEEP_RTOL = 1e-8        # the sweep's lanes 0-2, GPU against CPU, f64
SWEEP_CPU_LANES = 3
LANES_SHAPES = ((K2_LANES, 120, 1, 3), (K2_LANES, 1, 1, 3), (3, 7, 1, 3),
                (7, 129, 4, 4))


def _k2_lanes_bit_equal():
    """K2's lanes launch against its plain version on the card and against
    L single `chunk_draws` launches, bit for bit, at the sweep's shape
    (100 lanes x 120 rounds, K = 1, dim = 3), a one-round chunk, a few
    lanes and a two-segment chunk (rr = 129 > SEG) with K = 4, f32 and
    f64. Returns the count of records compared."""
    from ccgp_tpu_torch.ops import rng

    n = 0
    for lanes, rr, kk, dim in LANES_SHAPES:
        keys = rng.split(rng.PRNGKey(lanes + rr, device="cuda"), lanes)
        for dtype in (torch.float32, torch.float64):
            got = rng.chunk_draws_lanes(keys, rr, kk, dim, dtype)
            ref = rng.chunk_draws_lanes_plain(keys, rr, kk, dim, dtype)
            one = [rng.chunk_draws(keys[i], rr, kk, dim, dtype)
                   for i in range(lanes)]
            torch.cuda.synchronize()
            for i, what in ((0, "keys"), (1, "normals"), (2, "log-uniforms")):
                single = torch.stack([o[i] for o in one])
                bits = (lambda t: t) if i == 0 else _bits
                if not (torch.equal(bits(got[i]), bits(ref[i]))
                        and torch.equal(bits(got[i]), bits(single))):
                    raise AssertionError(
                        f"chunk_draws_lanes {what} differ at L={lanes} "
                        f"rr={rr} K={kk} dim={dim} {dtype}")
            n += 1
    log(f"[20] chunk_draws_lanes == its plain version == L single "
        f"chunk_draws launches, bit for bit, on {n} of {n} records (L x rr x "
        f"K x dim in {LANES_SHAPES}, f32 and f64)")
    return 0.0


def _device_ns(prof, since_ns=None) -> int:
    """The device time (ns) of a profiler's records, from its raw results
    (millions of records take minutes to turn into FunctionEvents,
    seconds to sum raw); with since_ns, only records that start after it
    (the profiler's clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda
               and (since_ns is None or e.start_ns() >= since_ns))


class _Window(Exception):
    """Ends a profiled window of the lane loop."""


SWEEP_WINDOW_CHUNKS = 3     # lane-loop chunks (120 rounds each) profiled
SWEEP_LAPLACE_LANES = 5     # Laplace fits profiled


def _sweep_busy(lanes, n_max, samp):
    """The sweep's device-busy share under torch.profiler, in two windows
    (the whole sweep is ~10^7 device records, which the profiler takes
    minutes to hand over): the Laplace fits of the first
    SWEEP_LAPLACE_LANES designs, and SWEEP_WINDOW_CHUNKS x 120 rounds of
    the lane loop on all 100 lanes, resumed from the sweep's own fits and
    stopped at the next chunk's draws. Returns (Laplace share, loop
    share), each busy / wall of its window."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from ccgp_tpu_torch.infer import metropolis as metro
    from ccgp_tpu_torch.ops import rng

    lp, fits, keys = lanes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metro.laplace_lanes(lp, fits.mode[:SWEEP_LAPLACE_LANES].clone())
        torch.cuda.synchronize()
        lap_wall = (time.perf_counter() - t0) * 1e3
    lap = _device_ns(prof) / 1e6 / lap_wall
    calls = []

    def draws(*a):
        calls.append(time.perf_counter())
        if len(calls) > SWEEP_WINDOW_CHUNKS:
            torch.cuda.synchronize()
            raise _Window
        return rng.chunk_draws_lanes(*a)

    before = metro.rng
    metro.rng = SimpleNamespace(chunk_draws_lanes=draws)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            try:
                metro.metropolis_lanes(lp, fits.mode, keys, n_max=n_max,
                                       samp_size=samp, laplace_fits=fits)
            except _Window:
                pass
    finally:
        metro.rng = before
    loop_wall = (calls[-1] - calls[0]) * 1e3
    # the window's records: from the first chunk's draws on
    first = min(e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and "chunk_draws_lanes_kernel" in e.name())
    loop = _device_ns(prof, first) / 1e6 / loop_wall
    log(f"[20] sweep device busy under torch.profiler: the Laplace fits of "
        f"{SWEEP_LAPLACE_LANES} designs {100 * lap:.1f}% of {lap_wall:.0f} "
        f"ms; {SWEEP_WINDOW_CHUNKS * 120} lane-loop rounds on all lanes "
        f"{100 * loop:.1f}% of {loop_wall:.0f} ms "
        f"({loop_wall / (SWEEP_WINDOW_CHUNKS * 120):.2f} ms per round)")
    return lap, loop


def _sweep_cli_start(root):
    """Start `python -m ccgp_tpu_torch sim_2d_sweep --designs 100` (f32,
    the card) on the stand-ins under `root` in a child process;
    `_sweep_cli_end` collects it."""
    import os
    from pathlib import Path

    proc = subprocess.Popen(
        [sys.executable, "-m", "ccgp_tpu_torch", "sim_2d_sweep", "--designs",
         str(SWEEP_DESIGNS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=Path(__file__).resolve().parent,
        env={**os.environ, "CCGP_DATA_ROOT": str(root)})
    return proc, time.perf_counter()


def _sweep_cli_end(cli):
    proc, t0 = cli
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the sweep's CLI failed ({proc.returncode}):\n"
                             f"{out}\n{err[-3000:]}")
    lines = out.strip().splitlines()
    if len(lines) != 3 or not lines[0].startswith(
            f"sweep over {SWEEP_DESIGNS} designs"):
        raise AssertionError(f"the sweep's CLI printed {lines}")
    log(f"[20] CLI sim_2d_sweep --designs {SWEEP_DESIGNS} (f32, the card, "
        f"in a child process beside phases 3-14) in {secs:.1f} s: "
        + " / ".join(x.strip() for x in lines))


def phase_sweep(root):
    """The sweep at full width: the reference's 100 designs (stand-ins
    under `root`), Config()'s 15 x 15 lattice and MCMC budget, f64, key 0,
    every design a lane of the K = 1 sampler; then lanes 0-2 on the
    CPU. (Its CLI run in f32 goes beside phases 3-14.)"""
    from ccgp_tpu_torch.eval import datasets
    from ccgp_tpu_torch.experiments import sim_2d_sweep as sw
    from ccgp_tpu_torch.ops import rng

    err = _k2_lanes_bit_equal()
    before = datasets._DEFAULT_ROOTS
    try:
        datasets._DEFAULT_ROOTS = (str(root),)
        cfg = sw.Config(n_designs=SWEEP_DESIGNS)

        def run(stages=None):
            return sw.run(cfg, key=rng.PRNGKey(0, device="cuda"),
                          dtype=torch.float64, device="cuda", stages=stages)

        stages = {}
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(stages)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_counts()
        ch = stages.pop("chains")
        lanes = stages.pop("lanes")
        m = SWEEP_DESIGNS
        for f in ("rmspe", "coverage", "quant"):
            v = getattr(res, f)
            if v.shape != (m,) or not np.isfinite(v).all():
                raise AssertionError(f"sweep {f}: {v.shape}, non-finite")
        if not ((res.coverage >= 0) & (res.coverage <= 1)).all():
            raise AssertionError("sweep coverage outside [0, 1]")
        _require_launched(launches, ("chunk_draws_lanes",
                                     "chol_factors_lanes"), "sweep")
        iters = int(ch.n_rounds.max())
        if launches["chunk_draws_lanes"] != -(-iters // 120):
            raise AssertionError(f"K2's lanes launch ran {launches} times "
                                 f"for {iters} rounds")
        if launches["chol_factors_lanes"] != m:
            raise AssertionError(f"K4 ran {launches['chol_factors_lanes']} "
                                 f"times for {m} designs")
        shares = ", ".join(f"{k} {v:.2f} s ({100 * v / secs:.0f}%)"
                           for k, v in stages.items())
        log(f"[20] sweep over {m} designs (f64, key 0, n_max "
            f"{cfg.mcmc.n_max}, samp {cfg.mcmc.samp_size}, net "
            f"{cfg.mcmc.net_samp_size}, {cfg.n_new_axis}^2 lattice) on the "
            f"card: {secs:.2f} s; {shares}; {iters} rounds of the lane loop "
            f"(per lane {int(ch.n_rounds.min())}-{iters}, median "
            f"{int(np.median(ch.n_rounds))}, {int(ch.n_rounds.sum())} in "
            f"all), healthy chains {int(res.chain_ok.sum())}/{m}; RMSPE "
            f"median {np.median(res.rmspe):.4f}, coverage median "
            f"{np.median(res.coverage):.3f}, calibration mean "
            f"{res.quant.mean():.3f}; launches {launches}")
        lap, loop = _sweep_busy(lanes, cfg.mcmc.n_max,
                                cfg.mcmc.samp_size)
        est = (lap * stages["laplace"] + loop * stages["rounds"]) / secs
        log(f"[20] the sweep's device-busy share, its Laplace and lane-loop "
            f"stages weighted by their times (the plug-in and predict, "
            f"{100 * (stages['plug-in'] + stages['predict']) / secs:.1f}% of "
            f"it, not profiled): {100 * est:.1f}%")

        # lanes 0-2 on the CPU: the same designs and keys
        designs = torch.tensor(np.stack([datasets.load_2d_training_design(i)
                                         for i in range(1, SWEEP_CPU_LANES + 1)]),
                               dtype=torch.float64)
        keys = rng.split(rng.PRNGKey(0, device="cpu"), m)[:SWEEP_CPU_LANES]
        x_new, y_true = sw.design_grid(cfg, torch.float64, torch.device("cpu"))
        cst = {}
        t0 = time.perf_counter()
        cpu = sw.sweep(cfg, designs, keys, x_new, y_true, cst)
        csecs = time.perf_counter() - t0
        cc = cst.pop("chains")
        cst.pop("lanes")
        for f in ("n_recorded", "n_proposals", "n_accepted"):
            if not np.array_equal(getattr(ch, f)[:SWEEP_CPU_LANES],
                                  getattr(cc, f)):
                raise AssertionError(f"sweep lanes 0-2 {f}: card "
                                     f"{getattr(ch, f)[:3]}, CPU "
                                     f"{getattr(cc, f)}")
        worst = 0.0
        for f, c in zip(("rmspe", "coverage", "quant"), cpu[:3]):
            g = getattr(res, f)[:SWEEP_CPU_LANES]
            worst = max(worst, float(np.max(np.abs(g - c)
                                            / np.maximum(np.abs(c), 1e-300))))
        if not worst <= SWEEP_RTOL:
            raise AssertionError(f"sweep lanes 0-2 card vs CPU: {worst:.3e}")
        if not np.array_equal(res.chain_ok[:SWEEP_CPU_LANES], cpu[3]):
            raise AssertionError("sweep lanes 0-2: chain_ok differs")
        log(f"[20] sweep lanes 0-{SWEEP_CPU_LANES - 1} on the CPU ({csecs:.1f} "
            f"s; " + ", ".join(f"{k} {v:.2f} s" for k, v in cst.items())
            + f"): the same chains (recorded {cc.n_recorded.tolist()}, "
            f"proposals {cc.n_proposals.tolist()}), summaries within "
            f"{worst:.2e} of the card's (guard {SWEEP_RTOL:g})")
    finally:
        datasets._DEFAULT_ROOTS = before
    return launches, err


HMC_RTOL = 1e-6   # HMC samples, card against CPU, f64
HMC_STRICT_DRAWS = 50
HMC_LEAPFROG = 8


def _hmc_run(device, n_warmup=200, n_samples=200):
    """HMC on the sweep's first stand-in design's posterior (its plug-in
    sigma^2 and priors, f64), preconditioned by its Laplace covariance."""
    from ccgp_tpu_torch.eval.functions import test_function_2d
    from ccgp_tpu_torch.experiments import sim_2d_sweep as sw
    from ccgp_tpu_torch.infer.hmc import hmc
    from ccgp_tpu_torch.infer.laplace import laplace
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.likelihood import make_logpost
    from ccgp_tpu_torch.models.priors import InverseGamma
    from ccgp_tpu_torch.ops import kernels, rng

    x = torch.tensor(sweep_standin_designs(1)[0], device=device)
    y = test_function_2d(x, 2)
    s2 = sw.plugin_sigma2(x[None], y[None], 1e-5)[0]
    fam = kernels.sqexp_family()
    lp = make_logpost(MixtureSpec(fam, fam, dim=2), x, y, s2,
                      theta1_prior=InverseGamma(3, 2),
                      theta2_prior=InverseGamma(5, 16), jitter=1e-5)
    start = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64, device=device)
    fit = laplace(lambda z: lp(z).val, start)
    t0 = time.perf_counter()
    res = hmc(lambda z: lp(z).val, fit.mode.detach(),
              rng.PRNGKey(3, device=device), n_samples=n_samples,
              n_warmup=n_warmup, n_leapfrog=HMC_LEAPFROG,
              mass_cov=fit.cov.detach())
    if device != "cpu":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _hmc_compare(tag, g, c):
    d = (g.samples.cpu() - c.samples).abs().amax(-1).numpy()
    far = np.flatnonzero(d > HMC_RTOL)
    step = abs(float(g.step_size) - float(c.step_size))
    log(f"[21] HMC {tag}, card vs CPU: step sizes {float(g.step_size):.6g} / "
        f"{float(c.step_size):.6g} (differ by {step:.2e}), divergent "
        f"{int(g.n_divergent)} / {int(c.n_divergent)}, accept "
        f"{float(g.accept_rate):.3f} / {float(c.accept_rate):.3f}; samples "
        + (f"within {float(d.max()):.2e} (guard {HMC_RTOL:g})" if not far.size
           else f"part at draw {int(far[0])} of {len(d)} (max difference "
                f"{float(d.max()):.3g}; within {float(d[:far[0]].max()) if far[0] else 0.0:.2e} "
                "before it)"))
    return far


def phase_parallel_surface(twins=None):
    """`dryrun_multichip(4)` on the card repeated four times against the
    one-device mesh; HMC on the card against the CPU (f64, 200 warmup and
    200 draws, then 50 draws without warmup); `entry()`'s forward."""
    from ccgp_tpu_torch.graft_entry import _flagship, dryrun_multichip, entry

    _zero_counts()
    t0 = time.perf_counter()
    par = dryrun_multichip(4, device="cuda")
    launches = _read_counts()
    log(f"[21] dryrun_multichip(4) on cuda:0 x 4 in "
        f"{time.perf_counter() - t0:.1f} s: parities against the one-device "
        f"mesh " + ", ".join(f"{k} {v:.2e}" for k, v in par.items())
        + f" (guard 1e-4); launches {launches}")
    _require_launched(launches, ("chunk_draws_lanes",), "dry run")

    g, gs = _hmc_run("cuda")
    c, cs = twins.get("hmc") if twins is not None else _hmc_run("cpu")
    log(f"[21] HMC 200 warmup + 200 draws ({HMC_LEAPFROG} leapfrog steps, f64): "
        f"{gs:.1f} s on the card, {cs:.1f} s on the CPU")
    if not (torch.all(torch.isfinite(g.samples)) and g.samples.shape
            == (200, 3)):
        raise AssertionError("HMC on the card: non-finite or misshapen")
    _hmc_compare("with warmup", g, c)
    # without warmup the step size is fixed and the chains stay together
    g0, _ = _hmc_run("cuda", n_warmup=0, n_samples=HMC_STRICT_DRAWS)
    c0, _ = (twins.get("hmc without warmup") if twins is not None
             else _hmc_run("cpu", n_warmup=0, n_samples=HMC_STRICT_DRAWS))
    if _hmc_compare(f"{HMC_STRICT_DRAWS} draws without warmup", g0,
                    c0).size:
        raise AssertionError("HMC without warmup parts between the card "
                             "and the CPU")

    f, args = entry()
    out = f(*args)
    if not all(bool(torch.all(torch.isfinite(o))) for o in out):
        raise AssertionError("entry() forward is not finite")
    fg, ag = _flagship(torch.float64, "cuda")
    fc, ac = _flagship(torch.float64, "cpu")
    worst = max(_rel_err(a, b) for a, b in zip(fg(*ag), fc(*ac)))
    if not worst <= F64_RTOL:
        raise AssertionError(f"entry forward f64 card vs CPU: {worst:.3e}")
    log(f"[21] entry() forward on the card: log-posterior "
        f"{float(out[0]):.6g}, mean {tuple(out[1].shape)}, var "
        f"{tuple(out[2].shape)}, finite; f64 card vs CPU within {worst:.2e}")
    return launches


# phase 22: the options and names the port took over last
GAPS_DESIGN = 0             # the stand-in Train_Design that 22a fits
GAPS_CHAINS = 4             # 22e's chains, two per shard
GAPS_CHAIN_RUN = dict(n_max=200, samp_size=100, alpha_geweke=0.9,
                      max_proposals=2000)
GAPS_SWEEP = 6              # 22e's one-design sweep: designs on cuda:0 x 2
# 22a's study, GPU against CPU: on this design the plug-in sigma^2 parts
# by 4e-10 and the draws by 1.9e-8 (an H100 against its host's CPU), the
# chain carrying the roundoff of two BFGS stopping points (`mlegp_fit`'s,
# the Laplace fit's); phase 16's design stays within 1e-8. 1e-7 is
# PATH_1D_RTOL, the CPU tests' limit for a BFGS plug-in against JAX
GAPS_STUDY_RTOL = PATH_1D_RTOL
K2_WIDE = (1 << 12, 1 << 12)   # 22f: K, dim, 2^24 draws a round
MOMENTS_ATOL = (1e-8, 1e-12)   # JAX's tests/test_predict.py:214-215
CGP_RTOL, MLEGP_RTOL = 1e-8, (1e-6, 1e-7)   # tests/test_torch_baselines.py


def gaps_design() -> np.ndarray:
    """22a's design: stand-in Train_Design GAPS_DESIGN + 1, (14, 2)."""
    return sweep_standin_designs(GAPS_DESIGN + 1)[GAPS_DESIGN]


def _aniso_cfg():
    """sim_2d_aniso's Config with speculative K = 4, as the CLI runs it."""
    from ccgp_tpu_torch.experiments import sim_2d_aniso
    from ccgp_tpu_torch.models.combined_gp import MCMCConfig

    cfg = sim_2d_aniso.Config()
    return type(cfg)(**{**cfg.__dict__, "mcmc": MCMCConfig(
        **{**cfg.mcmc.__dict__, "speculative": 4})})


def _same_study(a, b) -> bool:
    """Two StudyResults bit for bit: chain, draws, predictions, summary."""
    ma, mb = a.fit.mcmc, b.fit.mcmc
    return ((ma.n_recorded, ma.n_proposals, ma.n_rounds)
            == (mb.n_recorded, mb.n_proposals, mb.n_rounds)
            and torch.equal(a.fit.zs, b.fit.zs)
            and set(a.predictions) == set(b.predictions)
            and all(np.array_equal(getattr(p, f),
                                   getattr(b.predictions[m], f))
                    for m, p in a.predictions.items()
                    for f in ("mean", "lower", "upper"))
            and a.summary == b.summary)


def _study_err(g, c) -> dict:
    """Two devices' `_case_record`s of one study: the same chain, and the
    largest relative difference (`_rel_err`) of the plug-in sigma^2, the
    draws, each model's mean and interval, and the summary."""
    if g["chain"] != c["chain"] or g["chain_ok"] != c["chain_ok"]:
        raise AssertionError(f"chain {g['chain']} on the GPU, {c['chain']} "
                             f"on the CPU")
    errs = {"sigma2": abs(g["sigma2"] - c["sigma2"]) / max(1.0,
                                                          abs(c["sigma2"])),
            "draws": _rel_err(g["zs"], c["zs"])}
    for m, fields in c["predictions"].items():
        errs[m] = max(_rel_err(g["predictions"][m][f], fields[f])
                      for f in ("mean", "lower", "upper"))
    (gr, gc, gq), (cr, cc, cq) = g["summary"], c["summary"]
    errs["summary"] = max([abs(gr[k] - cr[k]) for k in cr]
                          + [abs(gc[k] - cc[k]) for k in cc] + [abs(gq - cq)])
    return errs


def _gaps_study(study16, twins=None):
    """22a and 22b: `sim_2d_aniso.run(design=D)` at Config()'s budget on
    the card and the CPU (`twins`' record, or run here), `run(design=<run()'s
    own design>)` against phase 16's `run()`, then `run_study`'s options on
    22a's data."""
    import warnings

    from ccgp_tpu_torch.design.lhs import maximin_lhs
    from ccgp_tpu_torch.experiments.common import run_study
    from ccgp_tpu_torch.experiments.sim_2d_iso import data_2d
    from ccgp_tpu_torch.models.combined_gp import MCMCConfig
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import rng

    spec = _spec()      # sim_2d_aniso's mixture
    cfg = _aniso_cfg()
    design = gaps_design()
    _zero_counts()
    rg, gpu_s = run_aniso("cuda", design)
    launches = _read_counts()
    c = (twins.get("sim_2d_aniso design") if twins is not None
         else _case_record(*run_aniso("cpu", design), {}, None))
    cpu_s = c["secs"]
    err = _study_err(_case_record(rg, gpu_s, {}, None), c)
    mg = rg.fit.mcmc
    log(f"[22a] sim_2d_aniso.run(design=stand-in Train_Design "
        f"{GAPS_DESIGN + 1}) at Config()'s budget (n=14, n_max 5000, samp "
        f"1000, f64, K=4): n_recorded={mg.n_recorded} n_proposals="
        f"{mg.n_proposals} n_rounds={mg.n_rounds} chain_ok="
        f"{rg.fit.chain_ok}; GPU: {_summary_line(rg)}; GPU == CPU: "
        f"{', '.join(f'{k} {v:.3g}' for k, v in err.items())} (tol "
        f"{GAPS_STUDY_RTOL:g}); {gpu_s:.1f} s on the GPU, {cpu_s:.1f} s on "
        f"the CPU; launches={launches}")
    if not max(err.values()) <= GAPS_STUDY_RTOL:
        raise AssertionError("22a: the given design's study differs GPU "
                             "vs CPU")
    if not all(math.isfinite(v) for v in rg.summary.rmspe.values()):
        raise AssertionError(f"22a: non-finite RMSPE {rg.summary.rmspe}")
    _require_launched(launches, ("fused_mix_mh_rounds", "chunk_draws"),
                      "given-design study")
    key = rng.PRNGKey(0, device="cuda")
    own = maximin_lhs(rng.split(key)[0], cfg.n_train, 2, dtype=torch.float64)
    t0 = time.perf_counter()
    again, _ = run_aniso("cuda", own.cpu().numpy())
    if not _same_study(again, study16):
        raise AssertionError("22a: run(design=<run()'s design>) is not "
                             "run() bit for bit")
    log(f"[22a] run(design=<the design run() draws>) == phase 16's run() "
        f"bit for bit ({time.perf_counter() - t0:.1f} s)")

    # 22b: run_study's options on 22a's data, the same keys
    x, y, x_new, y_true, k_s = data_2d(cfg, key, torch.float64,
                                       torch.device("cuda"), design)
    priors = dict(theta1_prior=LogNormal(-1.0, 1.0),
                  theta2_prior=InverseGamma(3, 4))
    t0 = time.perf_counter()
    _zero_counts()
    rb = run_study(spec, x, y, x_new, y_true, k_s, cfg.mcmc, **priors,
                   single_variant="mlegp", run_single=False,
                   cgp_candidates=105, on_unconverged="raise",
                   device="cuda")
    b_launches = _read_counts()
    if "single" in rb.predictions or "cgp" not in rb.predictions:
        raise AssertionError(f"22b: models {sorted(rb.predictions)}")
    if not (torch.equal(rb.fit.zs, rg.fit.zs)
            and np.array_equal(rb.predictions["combined"].mean,
                               rg.predictions["combined"].mean)):
        raise AssertionError("22b: the combined GP is not 22a's")
    if not np.isfinite(rb.predictions["cgp"].mean).all():
        raise AssertionError("22b: the 105-candidate composite GP is not "
                             "finite")
    starved = MCMCConfig(start=cfg.mcmc.start, n_max=400, samp_size=300,
                         net_samp_size=200, max_proposals=40)
    short = dict(sigma2=float(rg.fit.sigma2), run_single=False,
                 run_cgp=False, device="cuda")
    try:
        run_study(spec, x, y, x_new, y_true, k_s, starved, **priors,
                  on_unconverged="raise", **short)
    except RuntimeError as e:
        if "unhealthy" not in str(e):
            raise
    else:
        raise AssertionError("22b: a starved chain did not raise")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ri = run_study(spec, x, y, x_new, y_true, k_s, starved, **priors,
                       on_unconverged="ignore", **short)
    if ri.fit.chain_ok or any(issubclass(w.category, RuntimeWarning)
                              for w in seen):
        raise AssertionError("22b: 'ignore' warned or the chain was "
                             "healthy")
    log(f"[22b] run_study(run_single=False, cgp_candidates=105, "
        f"on_unconverged='raise') on 22a's data: models "
        f"{sorted(rb.predictions)}, the combined GP 22a's bit for bit, "
        f"cgp rmspe {rb.summary.rmspe['cgp']:.6f}; a starved chain "
        f"(n_recorded {ri.fit.mcmc.n_recorded} of 300) raised under "
        f"'raise' and passed silently under 'ignore' "
        f"({time.perf_counter() - t0:.1f} s); launches={b_launches}")
    return launches, b_launches, (x, y, rg.fit.sigma2)


def _gaps_baselines(x, y):
    """22c: `cgp_fit` and `mlegp_fit` with their search options on the
    card against the CPU."""
    from ccgp_tpu_torch.infer.mle import mlegp_fit
    from ccgp_tpu_torch.models.composite_gp import cgp_fit
    from ccgp_tpu_torch.ops import kernels, rng

    t0 = time.perf_counter()
    cgp_opts = dict(jackknife=False, num_starts=3, nugget_l=0.01,
                    theta_l=1e-3, alpha_l=5.0, kappa_u=50.0)
    ml_opts = dict(n_random=4, maxiter=100, log_theta_low=-8.0,
                   log_theta_high=8.0)
    out = {}
    for dev in ("cuda", "cpu"):
        xd, yd = x.to(dev), y.to(dev)
        cf = cgp_fit(xd, yd, rng.PRNGKey(5, device=dev), **cgp_opts)
        mf = mlegp_fit(kernels.sqexp_family(), xd, yd,
                       rng.PRNGKey(6, device=dev), **ml_opts)
        out[dev] = (cf, mf)
    (cg, mg), (cc, mc) = out["cuda"], out["cpu"]
    if not (bool(torch.isnan(cg.rmscv)) and bool(torch.isnan(cc.rmscv))):
        raise AssertionError("22c: jackknife=False left an RMSCV")
    cgp_err = max(_rel_err(getattr(cg, f), getattr(cc, f))
                  for f in cg._fields if f != "rmscv")
    th_err, s2_err = (_rel_err(mg.theta, mc.theta),
                      max(_rel_err(mg.sigma2, mc.sigma2),
                          _rel_err(mg.beta, mc.beta)))
    log(f"[22c] cgp_fit({', '.join(f'{k}={v}' for k, v in cgp_opts.items())}"
        f") card vs CPU {cgp_err:.3g} (tol {CGP_RTOL:g}), rmscv NaN; "
        f"mlegp_fit({', '.join(f'{k}={v}' for k, v in ml_opts.items())}) "
        f"theta {th_err:.3g}, sigma2 / beta {s2_err:.3g} (tol "
        f"{MLEGP_RTOL[0]:g} / {MLEGP_RTOL[1]:g}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (cgp_err <= CGP_RTOL and th_err <= MLEGP_RTOL[0]
            and s2_err <= MLEGP_RTOL[1]):
        raise AssertionError("22c: the baselines' options part card vs CPU")


def _gaps_moments(fit, smi):
    """22d: `predictive_moments(solve_mode="inv_matmul")` against "trsm" at
    the bench shape in f64: the bench fit's 1000 retained draws, n = 100,
    the 25 x 25 lattice; both timed with CUDA events."""
    from ccgp_tpu_torch.predict.factors import build_factors
    from ccgp_tpu_torch.predict.posterior import predictive_moments

    x, y, grid = bench_data()
    t = lambda a: torch.tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    spec = _spec()
    cache = build_factors(spec, t(x), t(y), fit.zs.double(),
                          fit.cache.beta.double(), jitter=1e-3)
    s2 = fit.sigma2.double()
    moments = {mode: (lambda m=mode: predictive_moments(
        spec, cache, t(x), t(grid), s2, solve_mode=m))
        for mode in ("trsm", "inv_matmul")}
    (mt, vt), (mi, vi) = moments["trsm"](), moments["inv_matmul"]()
    if mt.shape != (fit.zs.shape[0], 625):
        raise AssertionError(f"22d: moments of shape {tuple(mt.shape)}")
    dm = float(torch.max(torch.abs(mt - mi)))
    dv = float(torch.max(torch.abs(vt - vi)))
    ms = {mode: _cuda_ms(fn, 5) for mode, fn in moments.items()}
    log(f"[22d] predictive_moments at m={mt.shape[0]} n=100 t=625 f64: "
        f"inv_matmul vs trsm means {dm:.3g} (atol {MOMENTS_ATOL[0]:g}), "
        f"variances {dv:.3g} (atol {MOMENTS_ATOL[1]:g}); trsm "
        f"{ms['trsm']:.3f} ms, inv_matmul {ms['inv_matmul']:.3f} ms per "
        f"call (CUDA events, 5 calls; {smi})")
    if not (dm <= MOMENTS_ATOL[0] and dv <= MOMENTS_ATOL[1]):
        raise AssertionError("22d: the solve modes disagree")
    return ms


def _gaps_parallel(x, y, sigma2):
    """22e: `multi_chain_metropolis` on the mesh ["cuda:0", "cpu"] against
    each shard's chains on its device alone, bit for bit; JAX's one-design
    `sharded_design_sweep` on cuda:0 x 2 against the designs one by one."""
    from ccgp_tpu_torch.models.likelihood import make_logpost
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import rng
    from ccgp_tpu_torch.parallel import (
        make_mesh, multi_chain_metropolis, sharded_design_sweep)

    spec = _spec()
    lp = make_logpost(spec, x, y, sigma2, theta1_prior=LogNormal(-1.0, 1.0),
                      theta2_prior=InverseGamma(3, 4))
    starts = torch.tensor([[1.0, 1.0, 0.0, 0.0]] * GAPS_CHAINS,
                          dtype=torch.float64, device="cuda")
    keys = rng.split(rng.PRNGKey(22, device="cuda"), GAPS_CHAINS)
    h = GAPS_CHAINS // 2
    t0 = time.perf_counter()
    _zero_counts()
    both = multi_chain_metropolis(lp, starts, keys,
                                  make_mesh(devices=["cuda:0", "cpu"]),
                                  **GAPS_CHAIN_RUN)
    launches = _read_counts()
    both_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone = [multi_chain_metropolis(lp, starts[:h], keys[:h],
                                    make_mesh(devices=["cuda:0"]),
                                    **GAPS_CHAIN_RUN),
             multi_chain_metropolis(lp.to("cpu"), starts[h:].cpu(),
                                    keys[h:].cpu(), make_mesh(devices=["cpu"]),
                                    **GAPS_CHAIN_RUN)]
    alone_s = time.perf_counter() - t0
    for sl, ref, dev in ((slice(0, h), alone[0], "cuda:0"),
                         (slice(h, None), alone[1], "cpu")):
        same = (all(torch.equal(getattr(both, f)[sl].cpu(),
                                getattr(ref, f).cpu())
                    for f in ("samples", "betas", "logposts"))
                and all(np.array_equal(getattr(both, f)[sl], getattr(ref, f))
                        for f in ("n_recorded", "n_proposals", "n_accepted",
                                  "pvalue")))
        if not same:
            raise AssertionError(f"22e: the {dev} shard's chains are not "
                                 f"its chains on {dev} alone")
    _require_launched(launches, ("chunk_draws_lanes",),
                      "two-device chains' CUDA shard")
    log(f"[22e] multi_chain_metropolis on ['cuda:0', 'cpu'] ({GAPS_CHAINS} "
        f"chains, a thread per device, {both_s:.1f} s): each shard's chains "
        f"== its device alone bit for bit (n_proposals "
        f"{both.n_proposals.tolist()}; the two alone one after the other "
        f"{alone_s:.1f} s); launches={launches}")

    designs = torch.tensor(sweep_standin_designs(GAPS_SWEEP),
                           device="cuda")
    dkeys = rng.split(rng.PRNGKey(23, device="cuda"), GAPS_SWEEP)

    def fit_one(d, k):
        lpd = make_logpost(spec, d, torch.sin(5.0 * d[:, 0]), 0.5,
                           theta1_prior=LogNormal(-1.0, 1.0),
                           theta2_prior=InverseGamma(3, 4), jitter=1e-5)
        out = lpd(0.1 * rng.normal(k, (4,), d.dtype))
        return out.val, out.beta

    vals, betas = sharded_design_sweep(fit_one, designs, dkeys,
                                       make_mesh(devices=["cuda:0"] * 2))
    ref = [fit_one(d, k) for d, k in zip(designs, dkeys)]
    if not (vals.shape == (GAPS_SWEEP,)
            and torch.equal(vals, torch.stack([r[0] for r in ref]))
            and torch.equal(betas, torch.stack([r[1] for r in ref]))):
        raise AssertionError("22e: the one-design sweep is not the designs "
                             "one by one")
    log(f"[22e] sharded_design_sweep(fit_one) on cuda:0 x 2: {GAPS_SWEEP} "
        f"designs, (val, beta) per design stacked and gathered, == the "
        f"designs one by one bit for bit")
    return launches


def _gaps_k2_wide(smi):
    """22f: K2 at K dim = 2^24 (rr = 1, f32), where it indexes a segment's
    draws in 64 bits: bit-equal to its twin on the card, timed."""
    from ccgp_tpu_torch.ops import rng

    kk, dim = K2_WIDE
    key = rng.PRNGKey(24, device="cuda")
    got = rng.chunk_draws(key, 1, kk, dim, torch.float32)
    ref = rng.chunk_draws_plain(key, 1, kk, dim, torch.float32)
    equal = (torch.equal(got[0], ref[0]) and torch.equal(_bits(got[1]),
                                                         _bits(ref[1]))
             and torch.equal(_bits(got[2]), _bits(ref[2])))
    del ref
    if not equal:
        raise AssertionError("22f: K2 at 2^24 draws a round differs from "
                             "its twin")
    fn = lambda: rng.chunk_draws(key, 1, kk, dim, torch.float32)  # noqa: E731
    call = _cuda_ms(fn, 10)
    k, how = _kernel_ms("chunk_draws", fn, 10, call)
    plain = _cuda_ms(lambda: rng.chunk_draws_plain(key, 1, kk, dim,
                                                   torch.float32), 2)
    bound = _k2_bound(1, kk, dim, 4)
    log(f"[22f] chunk_draws rr=1 K={kk} dim={dim} f32 (2^24 draws, 64-bit "
        f"indices): bit-equal to its twin; kernel {k:.4f} ms {how} "
        f"({call:.4f} ms per call), plain {plain:.3f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}); {smi}")
    return k, plain, bound


def phase_api_gaps(study16, fit, smi, twins=None):
    """Phase 22: the options and names the port took over last (22a-22f),
    each sub-phase's seconds logged."""
    t0 = time.perf_counter()
    a_launches, b_launches, (x, y, s2) = _gaps_study(study16, twins)
    log(f"[22a/b] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _gaps_baselines(x, y)
    log(f"[22c] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms = _gaps_moments(fit, smi)
    log(f"[22d] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e_launches = _gaps_parallel(x, y, s2)
    log(f"[22e] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k2 = _gaps_k2_wide(smi)
    log(f"[22f] phase {time.perf_counter() - t0:.1f} s")
    launches = {k: a_launches[k] + b_launches[k] + e_launches[k]
                for k in a_launches}
    return launches, ms, k2


# ---------------------------------------------------------------------------
# the CPU twins: the CPU sides of phases 16, 19, 21 and 22a, computed in a
# child process beside phase 12's card fits
# ---------------------------------------------------------------------------

# what the child computes, in order: the card's results in those phases
# depend on none of it, and it depends on nothing the card computes (the
# heat exchanger's CPU run scans the card's rows, so it stays in phase 19)
TWINS = ("sim_2d_aniso", "sim_2d_aniso design", "ground_vibrations",
         "sim_2d_iso_advanced fixed", "sim_2d_iso_advanced reference", "hmc",
         "hmc without warmup")


def _to_numpy(obj):
    """Tensors in nested tuples (NamedTuples too), lists and dicts to numpy,
    to cross a process boundary."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj):
    """`_to_numpy`'s inverse: numpy arrays back to CPU tensors."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_torch(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def _cpu_twins(queue) -> None:
    """TWINS one after another in a child process (spawn), each put on
    `queue` as (name, record as numpy) as soon as it is done, or ("error",
    the traceback). The studies read their own data root, the same files
    phase 19's; two threads, beside phase 12's CPU child."""
    import shutil
    import tempfile
    import traceback
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix="ccgp_twins_"))
    try:
        torch.set_num_threads(2)
        gv_data_root(tmp)
        standin_data_root(tmp)
        _data_root(tmp)
        for name in TWINS:
            if name == "sim_2d_aniso":
                rec = _case_record(*run_aniso("cpu"), {}, None)
            elif name == "sim_2d_aniso design":
                rec = _case_record(*run_aniso("cpu", gaps_design()), {}, None)
            elif name == "hmc":
                rec = _hmc_run("cpu")
            elif name == "hmc without warmup":
                rec = _hmc_run("cpu", n_warmup=0, n_samples=HMC_STRICT_DRAWS)
            else:
                rec = _case_record(*run_case(name, "cpu")[:4])
            queue.put((name, _to_numpy(rec)))
    except Exception:   # the parent raises with it
        queue.put(("error", traceback.format_exc()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _Twins:
    """The child that computes TWINS (`_cpu_twins`) and the records it has
    sent; `get` waits for one, `close` ends the child."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.child = ctx.Process(target=_cpu_twins, args=(self.queue,))
        self.child.start()
        self.got = {}

    def get(self, name):
        import queue

        deadline = time.monotonic() + 1800
        while name not in self.got:
            try:
                key, rec = self.queue.get(timeout=5)
            except queue.Empty:
                if not self.child.is_alive() or time.monotonic() > deadline:
                    raise AssertionError(f"the CPU twins ended without "
                                         f"{name}") from None
                continue
            if key == "error":
                raise AssertionError(f"the CPU twins failed:\n{rec}")
            self.got[key] = _to_torch(rec)
        return self.got[name]

    def close(self):
        """Join the child, which exits once its records are read, or kill
        it (a failed phase leaves records unread)."""
        self.child.join(timeout=60 if len(self.got) == len(TWINS) else 1)
        if self.child.is_alive():
            self.child.kill()
            self.child.join()


def _record(name, source, replaces, launches, err, timed):
    k, p, lib, (bound_ms, bound_by) = timed
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k, "plain_ms": p, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib}


def _k2_record(launches, err, times, wide):
    """K2's record with its two bounds: `bound_ms`, the roofline over the
    fused work, and `serial_floor_ms`, the key chain's serial floor;
    `bound` names the larger, the one that bounds. `wide_*`: phase 22f's
    launch at 2^24 draws a round (64-bit indices), its kernel, plain and
    bound ms."""
    rec = _record("chunk_draws", "ccgp_tpu_torch/csrc/threefry_split_chain.cu",
                  "ccgp_tpu/ops/pallas_rng.py:122", launches, err,
                  times[("chunk_draws", 120)])
    floor = times[("chunk_draws floor", 120)]
    rec.update(serial_floor_ms=floor,
               bound="serial_floor" if floor > rec["bound_ms"] else "roofline",
               wide_ms=wide[0], wide_plain_ms=wide[1],
               wide_bound_ms=wide[2][0])
    return rec


def _k2_lanes_record(launches, err, times):
    """K2's lanes launch at the sweep's shape in f64 (the sweep's type),
    with K2's two bounds: `bound_ms`, the roofline over all lanes' work,
    and `serial_floor_ms`, one lane's key chain (the lanes run side by
    side), which bounds; `singles_ms` the L single launches' device time
    it replaces; f32 beside it."""
    k, p, lib, (floor, _) = times[("chunk_draws_lanes", torch.float64)]
    roof = _k2_bound(120 * K2_LANES, 1, 3, 8)
    rec = _record("chunk_draws_lanes",
                  "ccgp_tpu_torch/csrc/threefry_split_chain.cu",
                  "ccgp_tpu/ops/pallas_rng.py:122", launches, err,
                  (k, p, lib, roof))
    rec.update(serial_floor_ms=floor,
               bound="serial_floor" if floor > roof[0] else "roofline",
               singles_ms=times[("chunk_draws_lanes singles",
                                 torch.float64)][0],
               ms_f32=times[("chunk_draws_lanes", torch.float32)][0])
    return rec


def _timed(tag, fn, *args):
    """fn(*args), logging its seconds under the phase's tag."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{tag} phase {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import shutil
    import tempfile

    name, smi = phase_device()
    phase_build()
    sweep_tmp = tempfile.mkdtemp(prefix="ccgp_sweep_")
    try:
        return _main(name, smi, sweep_tmp)
    finally:
        shutil.rmtree(sweep_tmp, ignore_errors=True)


def _main(name, smi, sweep_tmp) -> int:
    sweep_root = standin_data_root(sweep_tmp)
    # the sweep's f32 CLI run (phase 20) beside the bit-equality phases,
    # whose checks do not depend on time; collected before phase 5 times
    cli = _sweep_cli_start(sweep_root)
    try:
        rng_err = _timed("[3]", phase_rng)
        rounds_err = _timed("[4]", phase_rounds)
        lanes_err = _timed("[7]", phase_lanes)
        k5_err, k6_err, k7_err = _timed("[11]", phase_smallk)
        k8_err, k9_err = phase_k8_k9()
    finally:
        _sweep_cli_end(cli)
    paths = {}
    paths["full-Bayes"], fit, pred, bench_ms = _timed("[5]", phase_main_path)
    paths["MAP"], _, _ = _timed("[8]", phase_map)
    paths["EB"], _, _ = _timed("[9]", phase_eb)
    paths["lazy predict"] = _timed("[10]", phase_lazy, fit, pred)
    paths["K8/K9 entry points"] = _timed("[15]", phase_k8_k9_paths)
    # the kernel timings before the 1-D, one-round and study paths: after
    # their hundreds of thousands of small launches the profiler kept no
    # record of most timing loops
    times = _timed("[6]", phase_timing, fit)
    geweke_times, geweke_errs = _timed("[23]", phase_geweke)
    times.update(geweke_times)
    # the CPU sides of phases 16, 19, 21 and 22a, beside phase 12's card
    # fits (host-bound on one core)
    twins = _Twins()
    try:
        paths.update(_timed("[12]", phase_1d))
        paths.update(_timed("[13]", phase_one_round))
        t0 = time.perf_counter()
        paths["study sim_2d_aniso"], study16 = phase_study(twins)
        phase_baselines_1d()
        log(f"[16] phase {time.perf_counter() - t0:.1f} s")
        paths["whiten"], _ = _timed("[17]", phase_whiten, bench_ms)
        paths["ME design"], _, _ = _timed("[18]", phase_me_design)
        case_paths, _ = _timed("[19]", phase_case_studies, twins)
        paths.update(case_paths)
        paths["sweep"], k2l_err = _timed("[20]", phase_sweep, sweep_root)
        paths["parallel surface"] = _timed("[21]", phase_parallel_surface,
                                           twins)
        paths["API gaps"], _, k2_wide = _timed("[22]", phase_api_gaps,
                                               study16, fit, smi, twins)
    finally:
        twins.close()
    launches = {k: sum(c[k] for c in paths.values()) for k in _counted()}
    log(f"[launches] per path: {paths}")
    kernels = [
        _k2_record(launches["chunk_draws"], rng_err, times, k2_wide),
        _k2_lanes_record(launches["chunk_draws_lanes"], k2l_err, times),
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
        _record("chol_quadratics_smallk", "ccgp_tpu_torch/csrc/chol_smallk.cu",
                "ccgp_tpu/ops/pallas_chol_smallk.py:850",
                launches["chol_quadratics_smallk"], k5_err,
                times[("chol_quadratics_smallk", "1-D round")]),
        _record("fused_mix_quadratics_smallk",
                "ccgp_tpu_torch/csrc/chol_smallk.cu",
                "ccgp_tpu/ops/pallas_chol_smallk.py:960",
                launches["fused_mix_quadratics_smallk"], k6_err,
                times[("fused_mix_quadratics_smallk", "n=100")]),
        _record("fused_mix_mh_round", "ccgp_tpu_torch/csrc/chol_smallk.cu",
                "ccgp_tpu/ops/pallas_chol_smallk.py:1104",
                launches["fused_mix_mh_round"], k7_err,
                times[("fused_mix_mh_round", "n=100")]),
        _record("fused_mix_quadratics", "ccgp_tpu_torch/csrc/gram_chol.cu",
                "ccgp_tpu/ops/pallas_gram_chol.py:121",
                launches["fused_mix_quadratics"], k8_err,
                times[("fused_mix_quadratics", "eb_row")]),
        _record("chol_nll", "ccgp_tpu_torch/csrc/chol_nll.cu",
                "ccgp_tpu/ops/pallas_chol.py:186",
                launches["chol_nll"], k9_err,
                times[("chol_nll", "map_cloud")]),
        _geweke_record(launches["geweke_pvalue"], geweke_errs, times),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
