"""Batch axes split over a mesh (port of `ccgp_tpu/parallel/sharded.py`).

Each function splits its leading axis over the mesh's devices, padding
it to a multiple of the device count as `_pad_to` does (repeats of the
last row), runs each shard on its device and gathers the results on the
first device, where the padding is dropped. On a one-device mesh that is
one batched call; a mesh that repeats a device runs the same split, pad
and gather with its shards one after another. JAX's versions leave the
collectives to XLA; here the gather is explicit, and each shard computes
what the unsharded call computes on its rows.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ccgp_tpu_torch.eb.halton import halton
from ccgp_tpu_torch.eb.hyperpriors import marginal_likelihood
from ccgp_tpu_torch.infer.metropolis import metropolis_lanes
from ccgp_tpu_torch.models.combination import (
    MixtureSpec, mixed_cross, mixed_gram, unpack)
from ccgp_tpu_torch.ops import linalg, rng
from ccgp_tpu_torch.ops.gp import gls_beta
from ccgp_tpu_torch.parallel.mesh import Mesh


def _pad_to(arr: torch.Tensor, mult: int):
    """Pad the leading dim to a multiple of `mult` with repeats of the last
    row; returns (padded, original_length)."""
    n = arr.shape[0]
    pad = (-n) % mult
    if pad:
        arr = torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])])
    return arr, n


def _split(arr: torch.Tensor, mesh: Mesh) -> list:
    """The padded leading axis in mesh.size equal shards, shard i on the
    mesh's device i."""
    arr, _ = _pad_to(arr, mesh.size)
    per = arr.shape[0] // mesh.size
    return [arr[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.device_list)]


def _to(v, dev):
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def _gather(parts: list, n: int, dev):
    """The shards' outputs joined along the leading axis on `dev`, cut to
    the first n rows; tuples (NamedTuples too) are joined field by field,
    numpy arrays on the host."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])[:n]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)[:n]
    if isinstance(first, tuple):
        fields = [_gather([p[i] for p in parts], n, dev)
                  for i in range(len(first))]
        return (type(first)(*fields) if hasattr(first, "_fields")
                else tuple(fields))
    raise TypeError(f"cannot gather {type(first).__name__}")


def sharded_hyperpar_scan(spec: MixtureSpec, x: torch.Tensor,
                          y: torch.Tensor, grid: np.ndarray, sigma2,
                          mesh: Mesh, n_nodes: int = 1728,
                          tau: float = 100.0, jitter: float = 0.0):
    """EB hyperprior grid scan with the rows split over the mesh: each
    device scans its rows with `eb.hyperpriors.marginal_likelihood` (one
    `chol_quadratics` call per row: K3 at n <= 128 on the card), and the
    argmax is taken over the gathered rows. Returns (grid[argmax], the
    log-likelihoods (G,) on the host)."""
    nodes = halton(n_nodes, 1)[:, 0]
    rows = torch.as_tensor(np.asarray(grid), dtype=x.dtype)
    parts = []
    for shard in _split(rows, mesh):
        dev = shard.device
        xd, yd = x.to(dev), y.to(dev)
        nd = torch.as_tensor(nodes, dtype=x.dtype, device=dev)
        s2 = _to(sigma2, dev)
        parts.append(torch.stack([
            marginal_likelihood(spec, xd, yd, (r[0], r[1]), (r[2], r[3]), s2,
                                nd, tau=tau, jitter=jitter) for r in shard]))
    likes = _gather(parts, rows.shape[0], mesh.device_list[0])
    idx = int(torch.argmax(likes))
    return np.asarray(grid)[idx], likes.cpu().numpy()


def multi_chain_metropolis(logpost: Callable, starts: torch.Tensor,
                           keys: torch.Tensor, mesh: Mesh, **metro_kwargs):
    """Independent K = 1 chains split over the mesh: each shard's chains
    run as the lanes of one `infer.metropolis.metropolis_lanes` call
    (`metro_kwargs` are its keywords). logpost takes a batch of states
    (`make_logpost` does) and closes over one device's tensors, so the
    mesh must be that device, repeated or not. Returns the chains'
    LanesResult."""
    if len({str(d) for d in mesh.device_list}) > 1:
        raise NotImplementedError(
            "multi_chain_metropolis: a log-posterior closes over one "
            "device's tensors; give a mesh of that device")
    parts = [metropolis_lanes(logpost, s, k, **metro_kwargs)
             for s, k in zip(_split(starts, mesh), _split(keys, mesh))]
    return _gather(parts, starts.shape[0], mesh.device_list[0])


def sharded_design_sweep(fit: Callable, designs: torch.Tensor,
                         keys: torch.Tensor, mesh: Mesh):
    """The design sweep with the designs (m, n, d) and their keys (m, 2)
    split over the mesh: `fit(designs (m_s, n, d), keys (m_s, 2))` is
    called once per shard on the shard's device and returns a tensor, an
    array or a tuple of them with a leading (m_s,) axis. JAX vmaps a
    one-design fit; torch cannot vmap a host-driven chain, so `fit` takes
    the shard's whole batch (`experiments.sim_2d_sweep` runs it as lanes)."""
    parts = [fit(d, k) for d, k in zip(_split(designs, mesh),
                                       _split(keys, mesh))]
    return _gather(parts, designs.shape[0], mesh.device_list[0])


def sharded_posterior_predict(spec: MixtureSpec, x: torch.Tensor,
                              y: torch.Tensor, x_new: torch.Tensor,
                              zs: torch.Tensor, betas: torch.Tensor, sigma2,
                              mesh: Mesh, jitter: float = 0.0,
                              var_scale: str = "sigma2",
                              normalized_cross: bool = True):
    """Posterior-predictive moments with the retained draws split over the
    mesh: each device builds its draws' factors (`build_factors`: K4 for
    64 or more draws at n <= 128 on the card) and their moments
    (`predictive_moments`); the cross-draw mean mu0 is taken over the
    gathered real draws. Returns (draw_mean (m, t), draw_var (m, t),
    mu0 (t,))."""
    from ccgp_tpu_torch.predict.factors import build_factors
    from ccgp_tpu_torch.predict.posterior import predictive_moments

    m = zs.shape[0]
    parts = []
    for zs_s, b_s in zip(_split(zs, mesh), _split(betas, mesh)):
        dev = zs_s.device
        xd = x.to(dev)
        cache = build_factors(spec, xd, y.to(dev), zs_s, b_s, jitter=jitter)
        parts.append(predictive_moments(spec, cache, xd, x_new.to(dev),
                                        _to(sigma2, dev),
                                        var_scale=var_scale,
                                        normalized_cross=normalized_cross))
    dev0 = mesh.device_list[0]
    ndev = mesh.size
    dm = _gather([p[0] for p in parts], m + (-m) % ndev, dev0)
    dv = _gather([p[1] for p in parts], m + (-m) % ndev, dev0)
    # padded rows repeat the last real draw: sum the real rows only and
    # divide by the true draw count
    mask = (torch.arange(dm.shape[0], device=dev0) < m).to(dm.dtype)
    mu0 = torch.einsum("m,mt->t", mask, dm) / m
    return dm[:m], dv[:m], mu0


class TrainStepState(NamedTuple):
    """Per-chain MCMC state for the distributed training step."""

    z: torch.Tensor          # (c, p) current unconstrained parameters
    lp: torch.Tensor         # (c,) current log-posterior values
    key: torch.Tensor        # (c, 2) PRNG keys
    accepts: torch.Tensor    # (c,) running acceptance counts


def distributed_train_step(spec: MixtureSpec, x: torch.Tensor,
                           y: torch.Tensor, x_eval: torch.Tensor, sigma2,
                           prop_chol: torch.Tensor, mesh: Mesh,
                           theta1_prior=None, theta2_prior=None,
                           jitter: float = 0.0):
    """The multi-device training step of the combined GP. One step: for
    every chain (split over the mesh) one Metropolis proposal and accept,
    then the predictive mean over the monitoring grid x_eval at the
    chain's new parameters; the grid means are averaged over the chains
    after the gather. The draws are JAX's: `key, k1, k2 = split(key, 3)`,
    `normal(k1, (p,))` and `uniform(k2)` per chain.

    Returns (step, make_state): step(state) -> (state, metrics),
    make_state(key, n_chains, z0) -> the first state on the mesh's first
    device."""
    from ccgp_tpu_torch.models.likelihood import make_logpost

    dim = prop_chol.shape[-1]
    per_dev = {}

    def on(dev):
        """x, y, x_eval, prop_chol and the log-posterior on `dev`."""
        if dev not in per_dev:
            xd, yd = x.to(dev), y.to(dev)
            per_dev[dev] = (xd, yd, x_eval.to(dev), prop_chol.to(dev),
                            make_logpost(spec, xd, yd, _to(sigma2, dev),
                                         theta1_prior=theta1_prior,
                                         theta2_prior=theta2_prior,
                                         jitter=jitter))
        return per_dev[dev]

    def chains(z, lp, key):
        xd, yd, xe, pc, logpost = on(z.device)
        ch = rng.split(key, 3)
        key, k1, k2 = ch[:, 0], ch[:, 1], ch[:, 2]
        eps = rng.normal(k1, (dim,), z.dtype)
        cand = z + (pc @ eps[..., None])[..., 0]
        out = logpost(cand)
        accept = (out.val - lp) > torch.log(rng.uniform(k2, (), z.dtype))
        z_new = torch.where(accept[:, None], cand, z)
        lp_new = torch.where(accept, out.val, lp)
        # predictive mean on the monitoring grid at the new parameters
        params, _ = unpack(spec, z_new)
        chol = linalg.jitter_cholesky(mixed_gram(spec, xd, params), jitter)
        beta = gls_beta(chol, yd)
        v = linalg.tri_solve(chol, mixed_cross(spec, xd, xe, params))
        a = linalg.tri_solve(chol, yd - beta[:, None])
        mean = beta[:, None] + torch.einsum("cn,cnt->ct", a, v)
        return z_new, lp_new, key, accept, mean

    def step(state: TrainStepState):
        c = state.z.shape[0]
        with torch.no_grad():
            parts = [chains(z, lp, k) for z, lp, k in zip(
                _split(state.z, mesh), _split(state.lp, mesh),
                _split(state.key, mesh))]
        z, lp, key, acc, means = _gather(parts, c, mesh.device_list[0])
        new_state = TrainStepState(z=z, lp=lp, key=key,
                                   accepts=state.accepts + acc.to(z.dtype))
        metrics = {"acc_rate": torch.mean(acc.to(z.dtype)),
                   "mean_logpost": torch.mean(lp),
                   "grid_mean": torch.mean(means, dim=0)}
        return new_state, metrics

    def make_state(key: torch.Tensor, n_chains: int, z0: torch.Tensor):
        dev = mesh.device_list[0]
        key, z0 = key.to(dev), z0.to(dev)
        k_chains, k_perturb = rng.split(key)
        keys = rng.split(k_chains, n_chains)
        zs = torch.tile(z0[None], (n_chains, 1))
        # perturb chains so they differ
        zs = zs + 0.01 * rng.normal(k_perturb, tuple(zs.shape), zs.dtype)
        with torch.no_grad():
            lps = on(dev)[4](zs).val
        return TrainStepState(z=zs, lp=lps, key=keys,
                              accepts=torch.zeros(n_chains, dtype=zs.dtype,
                                                  device=dev))

    return step, make_state
