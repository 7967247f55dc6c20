"""Batch axes split over a mesh (port of `ccgp_tpu/parallel/sharded.py`).

Each function splits its leading axis over the mesh's devices, padding
it to a multiple of the device count as `_pad_to` does (repeats of the
last row), runs each shard on its device and gathers the results on the
first device, where the padding is dropped. On a one-device mesh that is
one batched call; a mesh that repeats a device runs the same split, pad
and gather with its shards one after another. `multi_chain_metropolis`
and `sharded_design_sweep` run the shards of distinct devices at once,
one host thread per device (`_on_devices`). JAX's versions leave the
collectives to XLA; here the gather is explicit, and each shard computes
what the unsharded call computes on its rows.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
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


def _on_devices(fn: Callable, mesh: Mesh, *arrays) -> list:
    """fn(device, *shard) for each shard of the arrays (`_split`), in shard
    order. Where the mesh holds one device, repeated or not, the calls run
    one after another on the caller's thread. Else each distinct device
    gets a host thread that runs its shards in order, under that device
    (the current CUDA device, which a kernel launch uses) and the caller's
    grad mode; an exception in a shard is raised here once every thread has
    ended."""
    devs = mesh.device_list
    shards = list(zip(*(_split(a, mesh) for a in arrays)))
    names = list(dict.fromkeys(str(d) for d in devs))
    if len(names) == 1:
        return [fn(d, *s) for d, s in zip(devs, shards)]
    grad = torch.is_grad_enabled()

    def run(name):
        dev = torch.device(name)
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx, torch.set_grad_enabled(grad):
            return {i: fn(d, *s) for i, (d, s) in enumerate(zip(devs, shards))
                    if str(d) == name}

    out = {}
    with ThreadPoolExecutor(len(names)) as pool:
        futures = [pool.submit(run, name) for name in names]
    for f in futures:
        out.update(f.result())
    return [out[i] for i in range(len(shards))]


def _gather(parts: list, n: int, dev, stack: bool = False):
    """The shards' outputs joined along the leading axis on `dev` (stacked
    along a new one with stack=True), cut to the first n rows; tuples
    (NamedTuples too) are joined field by field, numpy arrays and scalars
    on the host."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        join = torch.stack if stack else torch.cat
        return join([p.to(dev) for p in parts])[:n]
    if isinstance(first, (np.ndarray, np.generic)):
        return (np.stack if stack else np.concatenate)(parts)[:n]
    if isinstance(first, tuple):
        fields = [_gather([p[i] for p in parts], n, dev, stack)
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
    (`metro_kwargs` are its keywords) on the shard's device. logpost takes
    a batch of states (`make_logpost`'s does). On a mesh of one device,
    repeated or not, it runs as given; on a mesh of distinct devices each
    device runs `logpost.to(device)` (`make_logpost` provides it), built
    before the shards start, and the devices run at once, a host thread
    each. A shard on `cuda:k` draws through K2's lanes launch there, one on
    the CPU through its plain twin. Returns the chains' LanesResult,
    gathered on the mesh's first device."""
    devs = {str(d): d for d in mesh.device_list}
    for d in devs.values():
        if d.type not in ("cpu", "cuda"):
            raise NotImplementedError(
                f"multi_chain_metropolis: chains run on CPU and CUDA "
                f"devices, not {d}")
    if len(devs) == 1:
        logposts = {name: logpost for name in devs}
    elif callable(getattr(logpost, "to", None)):
        logposts = {name: logpost.to(d) for name, d in devs.items()}
    else:
        raise TypeError(
            "multi_chain_metropolis: a mesh of distinct devices needs a "
            "log-posterior with .to(device), as make_logpost's has")
    parts = _on_devices(
        lambda dev, s, k: metropolis_lanes(logposts[str(dev)], s, k,
                                           **metro_kwargs),
        mesh, starts, keys)
    return _gather(parts, starts.shape[0], mesh.device_list[0])


def sharded_design_sweep(fit_one: Callable, designs: torch.Tensor,
                         keys: torch.Tensor, mesh: Mesh,
                         batched: bool = False):
    """The design sweep with the designs (m, n, d) and their keys (m, 2)
    split over the mesh, JAX's contract: `fit_one(design (n, d), key (2,))`
    fits one design and returns a tensor, an array or a tuple of them; it
    runs per design on its shard's device, and the results are stacked
    per shard and gathered on the mesh's first device. Distinct devices run
    at once, a host thread each. batched=True calls fit_one once per shard
    with the shard's designs (m_s, n, d) and keys (m_s, 2) and takes a
    leading (m_s,) axis back: `experiments.sim_2d_sweep` runs a shard's
    designs as the lanes of one sampler so."""
    if batched:
        def run(dev, d, k):
            return fit_one(d, k)
    else:
        def run(dev, d, k):
            return _gather([fit_one(di, ki) for di, ki in zip(d, k)],
                           d.shape[0], dev, stack=True)
    parts = _on_devices(run, mesh, designs, keys)
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
