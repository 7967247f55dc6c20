"""ccgp_tpu_torch — the convex-combination-of-GPs framework on PyTorch + CUDA.

A port of `ccgp_tpu` (JAX / Pallas) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a). The JAX package stays the reference:
every module here is held against its JAX counterpart by the tests in
`tests/test_torch_*.py`.

Layering mirrors `ccgp_tpu` (ops <- models <- infer / predict <-
experiments <- the CLI):

ops          distances, the correlation families (squared exponential,
             Matern through the Bessel K_v of `ops/bessel.py`, cubic
             spline), Cholesky linalg, the quadratics dispatcher and the
             kernels it routes to (`ops/chol_lanes.py`: wide batches;
             `ops/chol_smallk.py`: K <= 16 matrices; `ops/chol_nll.py`:
             the per-matrix kernel of use_pallas=True), the fused
             mixture-Gram kernel (`ops/gram_chol.py`, exported as
             `ops.fused_mix_quadratics`), special functions, the
             counter-based threefry RNG with `permutation` and `fold_in`
             (`ops/rng.py`, with the key-chain CUDA kernel and its lanes
             launch) and the fused speculative Metropolis rounds
             (`ops/chol_smallk.py`).
models       convex-combination covariance, priors, transformed
             log-posterior, the CombinedGP fit/predict pipeline, the two
             competitor baselines (`models/kriging.py`, the single GP;
             `models/composite_gp.py`, the composite GP) and the converter
             from the JAX package's state (`models/convert.py`).
infer        BFGS and its multistart, Laplace, Geweke, the effective
             sample size, the kriging MLE (BFGS, grid and the ARD
             `mlegp_fit`), the Metropolis drivers (K = 1, one-round
             speculative, chunked, and `metropolis_lanes`: the K = 1
             body for L designs at once) and HMC.
predict      per-draw factor caches, the draw-chunked moments and
             posterior-predictive aggregation.
eb           Halton nodes and the empirical-Bayes hyperprior scan.
design       random and maximin Latin hypercubes.
eval         the studies' test functions, the comparison summary, the
             data loaders, R-format tables and the plots.
experiments  the study runner (`run_study`: the combined GP and both
             baselines, compared), the reference's studies and the
             multi-design sweep; `python -m ccgp_tpu_torch <experiment>`
             (`__main__.py`) runs one and prints its RMSPE, coverage and
             calibration.
parallel     meshes of devices and the batch axes split over them.
utils        transforms, masked statistics and the entry points' device.

Entry points (`PRNGKey`, `models.convert`, `fit_combined_gp`,
`predict_combined_gp`, `eb.choose_hyperpars`, `run_study` and the
experiments' `run`, the CLI, `graft_entry.entry` and
`dryrun_multichip`) run on the GPU unless the CPU is asked for
(device="cpu", or --cpu); below them, functions take tensors and follow
their device and dtype. Randomness is an
explicit threefry key (an int64 tensor of shape (2,) holding two uint32
words), bit-compatible with `jax.random` under the partitionable layout.
CUDA sources live in `csrc/` and are compiled by `ops/_build.py` at first
use; a CPU tensor always takes the kernel's plain PyTorch twin.

This package never imports JAX.
"""

__version__ = "0.1.0"
