"""Entry points of the port (counterpart of the repo root's
`__graft_entry__.py`, which stays the JAX package's):

entry()             -> (forward, example_args): the forward step of the
                       flagship model (2-D anisotropic combined GP with
                       tied rough rates: the transformed log-posterior and
                       the posterior-predictive moments, the computation
                       every fit and predict loop runs), on the GPU unless
                       device="cpu".
dryrun_multichip(n) -> builds an n-device mesh, runs one distributed
                       training step (chains split over the mesh, the grid
                       means averaged after the gather) and the four other
                       functions of `parallel.sharded`, and asserts each
                       against the same call on a one-device mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from ccgp_tpu_torch.utils.device import resolve


def _flagship(dtype=torch.float32, device="cuda"):
    """(forward, (z0, x_new)) of the flagship model at n = 16 training and
    t = 32 prediction points from `default_rng(0)`, as JAX's `_flagship`."""
    from ccgp_tpu_torch.models.combination import (
        MixtureSpec, mixed_cross, unpack)
    from ccgp_tpu_torch.models.likelihood import make_logpost
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import kernels, linalg

    dev = resolve(device)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    rng = np.random.default_rng(0)
    n, t = 16, 32
    x = torch.tensor(rng.uniform(size=(n, 2)), dtype=dtype, device=dev)
    xh = x.cpu().numpy()
    y = torch.tensor(np.sin(5 * xh[:, 0]) + np.cos(3 * xh[:, 1]),
                     dtype=dtype, device=dev)
    x_new = torch.tensor(rng.uniform(size=(t, 2)), dtype=dtype, device=dev)
    sigma2 = torch.tensor(1.0, dtype=dtype, device=dev)
    logpost = make_logpost(spec, x, y, sigma2,
                           theta1_prior=LogNormal(-1.0, 1.0),
                           theta2_prior=InverseGamma(3, 4), jitter=1e-6)

    def forward(z, x_new):
        out = logpost(z)
        params, _ = unpack(spec, z)
        rx = mixed_cross(spec, x, x_new, params)
        v = linalg.tri_solve(out.chol, rx)
        a = linalg.tri_solve(out.chol, y - out.beta)
        u = linalg.tri_solve(out.chol, torch.ones_like(y))
        mean = out.beta + torch.einsum("n,nt->t", a, v)
        var = sigma2 * (1.0 - torch.einsum("nt,nt->t", v, v)
                        + (1.0 - torch.einsum("n,nt->t", u, v)) ** 2
                        / torch.sum(u * u))
        return out.val, mean, var

    z0 = torch.zeros(4, dtype=dtype, device=dev)
    return forward, (z0, x_new)


def entry(device="cuda"):
    """(forward, example_args) of the flagship model in float32."""
    return _flagship(torch.float32, device)


def _rel_delta(a, b) -> float:
    a = torch.as_tensor(a).double().cpu().numpy()
    b = torch.as_tensor(b).double().cpu().numpy()
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run one distributed training step and the four other sharded
    functions on an n_devices-device mesh, each against the same call on a
    one-device mesh (1e-4 relative, as JAX's dry run asserts), and return
    the parities. The mesh takes the first n_devices CUDA devices when
    there are that many, else `device` n_devices times over (the port's
    counterpart of XLA's virtual host devices): the shards then run one
    after another through the same split, pad and gather."""
    from ccgp_tpu_torch.models.combination import MixtureSpec
    from ccgp_tpu_torch.models.likelihood import make_logpost, make_logpost_lanes
    from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
    from ccgp_tpu_torch.ops import kernels, rng as trng
    from ccgp_tpu_torch.parallel import (
        distributed_train_step, make_mesh, multi_chain_metropolis,
        sharded_design_sweep, sharded_hyperpar_scan,
        sharded_posterior_predict)

    dtype = torch.float32
    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        mesh = make_mesh(n_devices)
    else:
        mesh = make_mesh(devices=[dev] * n_devices)
    mesh1 = make_mesh(devices=[mesh.device_list[0]])
    dev0 = mesh.device_list[0]

    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    rng = np.random.default_rng(0)
    n, t = 8, 16

    def tt(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev0)

    x = tt(rng.uniform(size=(n, 2)))
    y = tt(np.sin(5 * x[:, 0].cpu().numpy()))
    x_eval = tt(rng.uniform(size=(t, 2)))
    s2 = tt(0.5)
    prop_chol = 0.1 * torch.eye(3, dtype=dtype, device=dev0)
    priors = dict(theta1_prior=InverseGamma(3, 2),
                  theta2_prior=InverseGamma(5, 16))

    def one_step(m):
        step, make_state = distributed_train_step(
            spec, x, y, x_eval, s2, prop_chol, m, jitter=1e-5, **priors)
        state = make_state(trng.PRNGKey(0, device=dev0), n_chains, tt([0.0, 1.0, 0.0]))
        return step(state)[1]

    n_chains = max(2 * n_devices, mesh.shape["dp"] * 2)
    n_chains = -(-n_chains // mesh.shape["dp"]) * mesh.shape["dp"]
    metrics, metrics1 = one_step(mesh), one_step(mesh1)
    if not np.isfinite(float(metrics["mean_logpost"])):
        raise AssertionError("non-finite mean log-posterior")
    parities = {k: _rel_delta(metrics[k], metrics1[k])
                for k in ("mean_logpost", "acc_rate")}

    # (2) the EB hyperprior grid scan, rows split over the mesh
    hyper_grid = np.stack(
        [np.linspace(2.0, 4.0, 8), np.linspace(1.0, 3.0, 8),
         np.linspace(4.0, 6.0, 8), np.linspace(10.0, 30.0, 8)], axis=1)
    likes = [sharded_hyperpar_scan(spec, x, y, hyper_grid, s2, m, n_nodes=16,
                                   jitter=1e-5)[1] for m in (mesh, mesh1)]
    parities["eb_scan"] = _rel_delta(*likes)

    # (3) the design sweep: a cheap fit per design, designs split
    def fit(designs, keys):
        lp = make_logpost_lanes(spec, designs,
                                torch.sin(5.0 * designs[..., 0]), 0.5,
                                jitter=1e-5, **priors)
        return lp(0.1 * trng.normal(keys, (3,), designs.dtype)).val

    designs = tt(rng.uniform(size=(n_devices + 3, n, 2)))
    dkeys = torch.stack([trng.PRNGKey(i, device=dev0)
                         for i in range(n_devices + 3)])
    vals = [sharded_design_sweep(fit, designs, dkeys, m, batched=True)
            for m in (mesh, mesh1)]
    parities["design_sweep"] = _rel_delta(*vals)

    # (4) multi-chain Metropolis, chains split over the mesh
    lp = make_logpost(spec, x, y, s2, theta1_prior=LogNormal(-1.0, 1.0),
                      theta2_prior=InverseGamma(3, 4), jitter=1e-5)
    starts = torch.zeros((2 * n_devices, 3), dtype=dtype, device=dev0)
    ckeys = torch.stack([trng.PRNGKey(i, device=dev0)
                         for i in range(2 * n_devices)])
    res = [multi_chain_metropolis(lp, starts, ckeys, m, n_max=120,
                                  samp_size=40) for m in (mesh, mesh1)]
    parities["multi_chain"] = _rel_delta(res[0].n_recorded,
                                         res[1].n_recorded)

    # (5) posterior predict, the retained draws split over the mesh (a
    # ragged pad: 2 n + 3 draws)
    zs = tt(0.2 * rng.normal(size=(2 * n_devices + 3, 3)))
    betas = tt(0.1 * rng.normal(size=(2 * n_devices + 3,)))
    pp = [sharded_posterior_predict(spec, x, y, x_eval, zs, betas, s2, m,
                                    jitter=1e-5) for m in (mesh, mesh1)]
    parities["posterior_predict"] = max(_rel_delta(a, b)
                                        for a, b in zip(*pp))

    for name, d in parities.items():
        if not d < 1e-4:
            raise AssertionError(f"sharded-vs-1-device mismatch on {name}: "
                                 f"{d:.3e}")
    print(f"dryrun_multichip OK: {mesh}, chains={n_chains}, "
          f"acc_rate={float(metrics['acc_rate']):.2f}, "
          f"mean_logpost={float(metrics['mean_logpost']):.2f}; parity "
          "(n-device vs 1-device): "
          + ", ".join(f"{k}={v:.2e}" for k, v in parities.items()))
    return parities
