"""Multi-design 2-D simulation sweep (port of
`ccgp_tpu/experiments/sim_2d_sweep.py`).

The reference loops its 100 shipped Train_Designs serially through
`Combined.GP.fit` (`ReadMe.md:22-23`). JAX runs every design as a batch
lane of one jitted program (`jax.vmap(study_one)`); here every design is
a lane of one host loop per stage:

* the plug-in sigma^2: the profile NLL over a 32-point grid of log SE
  rates, all designs' (L, 32) Grams as one batch, the argmin's GLS
  sigma^2;
* the chains: `make_logpost_lanes` -> `metropolis_lanes` (the K = 1 body
  for all lanes at once: one batched log-posterior per round, the draws
  of every lane from one `chunk_draws_lanes` launch per 120 rounds);
* predict per design: `build_factors` (K4 for the 400 retained draws on
  the card), `predictive_moments` and `posterior_predict` with
  `fold_in(key_i, 7)`;
* RMSPE, 95% coverage, the calibration quantile and `chain_ok`.

With `mesh_devices > 1` the design axis is split over a mesh
(`parallel.sharded_design_sweep`), each shard a sweep of its own.

CLI: `python -m ccgp_tpu_torch sim_2d_sweep --designs 16 [--mesh N]`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ccgp_tpu_torch.eval.datasets import load_2d_training_design
from ccgp_tpu_torch.eval.functions import test_function_2d
from ccgp_tpu_torch.infer.metropolis import laplace_lanes, metropolis_lanes
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.likelihood import make_logpost_lanes
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, linalg, rng
from ccgp_tpu_torch.ops.gp import gls_beta, profile_nll, sigma2_mle
from ccgp_tpu_torch.predict.factors import build_factors
from ccgp_tpu_torch.predict.posterior import posterior_predict, predictive_moments
from ccgp_tpu_torch.utils.device import resolve


@dataclass(frozen=True)
class Config:
    func: int = 2
    n_designs: int = 16
    n_new_axis: int = 15
    jitter: float = 1e-5
    mesh_devices: int = 0      # 0/1 = single device; >1 = shard designs
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=3000,
                                  samp_size=600, net_samp_size=400)


class SweepResult(NamedTuple):
    rmspe: np.ndarray       # (m,) per-design combined-GP RMSPE
    coverage: np.ndarray    # (m,) 95% PI coverage
    quant: np.ndarray       # (m,) calibration quantile
    chain_ok: np.ndarray    # (m,) healthy-chain flags
    summary: None = None    # the CLI prints per-design medians instead


# the plug-in's grid of log SE rates, float32 as JAX builds it
MLE_GRID = np.linspace(-2.0, 5.0, 32, dtype=np.float32)


def plugin_sigma2(xs: torch.Tensor, ys: torch.Tensor, jitter: float):
    """The sweep's plug-in sigma^2 per design: the profile NLL of the
    isotropic SE Gram at each of MLE_GRID's 32 rates, all designs' (L, 32)
    Grams as one batch, then the GLS sigma^2 at each design's argmin
    (non-finite NLLs lose). The rates are exp of the float32 grid rounded
    to float32 (computed in float64: the correctly rounded value on both
    devices; XLA's float32 exp is one ulp off it at 5 of the 32 nodes),
    then taken to the designs' dtype, as JAX promotes them."""
    fam = kernels.sqexp_family()
    lt = torch.as_tensor(MLE_GRID, device=xs.device)
    theta = torch.exp(lt.double()).float().to(xs.dtype)          # (32,)
    grams = fam.gram(xs[:, None], theta[:, None])               # (L, 32, n, n)
    nlls = profile_nll(linalg.jitter_cholesky(grams, jitter), ys[:, None])
    nlls = torch.where(torch.isfinite(nlls), nlls,
                       torch.full_like(nlls, float("inf")))
    best = theta[torch.argmin(nlls, dim=1)]                     # (L,)
    ch = linalg.jitter_cholesky(fam.gram(xs, best[:, None]), jitter)
    return sigma2_mle(ch, ys, gls_beta(ch, ys))


def sweep(cfg: Config, designs: torch.Tensor, keys: torch.Tensor,
          x_new: torch.Tensor, y_true: torch.Tensor, stages: dict | None = None):
    """Every design (L, n, 2) a lane, keys (L, 2): returns (rmspe, coverage,
    quant, chain_ok), each (L,) on the host. `stages`, when given,
    collects each stage's host seconds (synchronized on a CUDA device),
    the lanes' chains ("chains") and what they ran on ("lanes": the lanes
    log-posterior, the Laplace fits and the keys)."""
    mc = cfg.mcmc
    dev, dtype = designs.device, designs.dtype
    fam = kernels.sqexp_family()
    spec = MixtureSpec(fam, fam, dim=2)

    def mark(name, t0):
        if stages is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    ys = test_function_2d(designs.reshape(-1, 2), cfg.func).reshape(
        designs.shape[:2])
    s2 = plugin_sigma2(designs, ys, cfg.jitter)
    t = mark("plug-in", t)
    lp = make_logpost_lanes(spec, designs, ys, s2,
                            theta1_prior=InverseGamma(3, 2),
                            theta2_prior=InverseGamma(5, 16),
                            jitter=cfg.jitter)
    starts = torch.tensor(mc.start, dtype=dtype, device=dev).expand(
        designs.shape[0], -1).contiguous()
    fits = laplace_lanes(lp, starts)
    t = mark("laplace", t)
    res = metropolis_lanes(lp, fits.mode, keys, n_max=mc.n_max,
                           samp_size=mc.samp_size, batch_size=mc.batch_size,
                           alpha_geweke=mc.alpha_geweke, record=mc.record,
                           max_proposals=mc.max_proposals, laplace_fits=fits)
    t = mark("rounds", t)
    zs, betas, _ = res.retained(mc.samp_size)
    keep = mc.samp_size - mc.net_samp_size
    zs, betas = zs[:, keep:], betas[:, keep:]
    out = []
    for i in range(designs.shape[0]):
        with torch.no_grad():
            cache = build_factors(spec, designs[i], ys[i], zs[i], betas[i],
                                  jitter=cfg.jitter)
            dm, dv = predictive_moments(spec, cache, designs[i], x_new, s2[i])
            pred = posterior_predict(rng.fold_in(keys[i], 7), dm, dv)
        e = y_true - pred.mean
        cover = ((y_true >= pred.lower) & (y_true <= pred.upper)).to(dtype)
        out.append(torch.stack([torch.sqrt(torch.mean(e * e)),
                                torch.mean(cover), torch.mean(pred.quant)]))
    summ = torch.stack(out).cpu().numpy()
    mark("predict", t)
    if stages is not None:
        stages["chains"] = res
        stages["lanes"] = (lp, fits, keys)
    return summ[:, 0], summ[:, 1], summ[:, 2], res.chain_ok(mc.samp_size)


def design_grid(cfg: Config, dtype, dev):
    """The prediction lattice (n_new_axis^2, 2) and the truth on it."""
    u = np.linspace(0, 1, cfg.n_new_axis)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    x_new = torch.tensor(grid, dtype=dtype, device=dev)
    return x_new, test_function_2d(x_new, cfg.func)


def run(cfg: Config = Config(), key=None, dtype=torch.float32,
        device="cuda", stages: dict | None = None) -> SweepResult:
    """The sweep over the first cfg.n_designs of the reference's
    Train_Designs (read under the data root, CCGP_DATA_ROOT), key split
    into one key per design, on `device` (the GPU unless "cpu")."""
    dev = resolve(device)
    key = rng.PRNGKey(0, device=dev) if key is None else key.to(dev)
    designs = torch.tensor(np.stack([load_2d_training_design(i + 1)
                                     for i in range(cfg.n_designs)]),
                           dtype=dtype, device=dev)
    keys = rng.split(key, cfg.n_designs)
    x_new, y_true = design_grid(cfg, dtype, dev)

    if cfg.mesh_devices and cfg.mesh_devices > 1:
        from ccgp_tpu_torch.parallel import make_mesh, sharded_design_sweep

        mesh = (make_mesh(cfg.mesh_devices) if dev.type == "cuda" else
                make_mesh(devices=[dev] * cfg.mesh_devices))

        def fit(d, k):
            xd, yd = x_new.to(d.device), y_true.to(d.device)
            r, c, q, ok = sweep(cfg, d, k, xd, yd)
            return r, c, q, ok

        out = sharded_design_sweep(fit, designs, keys, mesh, batched=True)
    else:
        out = sweep(cfg, designs, keys, x_new, y_true, stages)
    rmspe, cover, quant, ok = (np.asarray(o) for o in out)
    return SweepResult(rmspe=rmspe, coverage=cover, quant=quant, chain_ok=ok)
