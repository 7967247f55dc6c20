"""ccgp_tpu_torch — the convex-combination-of-GPs framework on PyTorch + CUDA.

A port of `ccgp_tpu` (JAX / Pallas) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a). The JAX package stays the reference:
every module here is held against its JAX counterpart by the tests in
`tests/test_torch_*.py`.

Layering mirrors `ccgp_tpu` (ops <- models <- infer / predict):

ops        distances, the correlation families (squared exponential,
           Matern through the Bessel K_v of `ops/bessel.py`, cubic
           spline), Cholesky linalg, the quadratics dispatcher and the
           kernels it routes to (`ops/chol_lanes.py`: wide batches;
           `ops/chol_smallk.py`: K <= 16 matrices, with the small-K CUDA
           kernels), special functions, the counter-based threefry RNG
           (`ops/rng.py`, with the key-chain CUDA kernel) and the fused
           speculative Metropolis rounds (`ops/chol_smallk.py`, with the
           rounds CUDA kernel).
models     convex-combination covariance, priors, transformed
           log-posterior, the CombinedGP fit/predict pipeline and the
           converter from the JAX package's state (`models/convert.py`).
infer      BFGS and its multistart, Laplace, Geweke, the effective sample
           size, the kriging MLE (BFGS and grid) and the Metropolis
           drivers (K = 1, one-round speculative, chunked).
predict    per-draw factor caches, the draw-chunked moments and
           posterior-predictive aggregation.
eb         Halton nodes and the empirical-Bayes hyperprior scan.
eval       the 1-D study's test functions.
utils      transforms, masked statistics and the entry points' device.

Entry points (`PRNGKey`, `models.convert`, `fit_combined_gp`,
`predict_combined_gp`, `eb.choose_hyperpars`) run on the GPU unless
device="cpu" is asked for; below them, functions take tensors and follow
their device and dtype. Randomness is an
explicit threefry key (an int64 tensor of shape (2,) holding two uint32
words), bit-compatible with `jax.random` under the partitionable layout.
CUDA sources live in `csrc/` and are compiled by `ops/_build.py` at first
use; a CPU tensor always takes the kernel's plain PyTorch twin.

This package never imports JAX.
"""

__version__ = "0.1.0"
