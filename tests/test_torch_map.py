"""The MAP program (`bench.py:92-174`) as `chip_smoke.map_fit_predict`
composes it from the port's library functions, against the same program
composed from the JAX package's functions, float64 on the CPU at n = 20
with a 64-point cloud and a 64-point zoom (both batches reach the lanes
kernel's plain twin; the 24-point plug-in grid takes the bordered path).

Tolerance: 1e-9 relative to max(1, |value|) for sigma^2, z_map, the
predictive mean and variance. JAX on the CPU factors every batch by its
bordered path, the port's scans by the right-looking twin: the two round
differently (jitter 1e-6), but the argmins and so z_map are the same.
"""
import jax.numpy as jnp
import numpy as np
import torch

from ccgp_tpu.eb import halton as jhalton
from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN
from ccgp_tpu.models import MixtureSpec as JSpec, make_logpost as jlogpost
from ccgp_tpu.models.combination import mixed_cross, mixed_gram, unpack
from ccgp_tpu.ops import kernels as jkern, linalg as jlin
from ccgp_tpu.ops.gp import gls_beta, sigma2_mle
from ccgp_tpu.ops.pallas_chol import (
    chol_quadratics, mvn_nll_from_quadratics, profile_nll_from_quadratics)
from ccgp_tpu_torch.ops import chol_lanes

import chip_smoke

JITTER = 1e-6


def jax_map_program(x, y, grid, n_cloud, n_zoom):
    """bench.py's fit_predict, eager, in float64 (jitter 1e-6)."""
    import jax

    fam = jkern.sqexp_family()
    spec = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2,
                 rough="tied", anisotropic=True)
    n = x.shape[0]
    mg = jnp.asarray(np.linspace(-5.0, 6.0, 24))
    grams0 = jax.vmap(lambda lt: fam.gram(x, jnp.exp(lt)))(mg)
    nlls = profile_nll_from_quadratics(
        chol_quadratics(grams0, y, jitter=JITTER), n)
    nlls = jnp.where(jnp.isfinite(nlls), nlls, jnp.inf)
    im = jnp.clip(jnp.argmin(nlls), 1, mg.shape[0] - 2)
    f0, f1, f2 = nlls[im - 1], nlls[im], nlls[im + 1]
    h = mg[1] - mg[0]
    denom = f0 - 2.0 * f1 + f2
    shift = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * h * (f0 - f2) / denom,
                      0.0)
    lt_opt = mg[im] + jnp.clip(shift, -h, h)
    chol0 = jlin.jitter_cholesky(fam.gram(x, jnp.exp(lt_opt)), JITTER)
    sigma2 = sigma2_mle(chol0, y, gls_beta(chol0, y))
    ln_prior, ig_prior = JLN(-1.0, 1.0), JIG(3, 4)

    def neg_logpost(zs):
        params, log_jac = jax.vmap(lambda z: unpack(spec, z))(zs)
        grams = jax.vmap(lambda p: mixed_gram(spec, x, p))(params)
        q = chol_quadratics(grams, y, jitter=JITTER)
        s2mix = params.p ** 2 + (1.0 - params.p) ** 2
        core = mvn_nll_from_quadratics(q, n, jnp.log(s2mix * sigma2))
        lp = (-0.5 * (core + n * float(np.log(2.0 * np.pi))) + log_jac
              + jnp.sum(ln_prior.log_kernel(params.theta1), axis=-1)
              + ig_prior.log_kernel(params.theta2))
        return jnp.where(jnp.isfinite(lp), -lp, jnp.inf)

    cloud = jnp.asarray(jhalton(n_cloud, 4) * np.array([6.0, 6.0, 8.0, 5.0])
                        + np.array([-2.0, -2.0, -4.0, -3.0]))
    vals = neg_logpost(cloud)
    z_best, v_best = cloud[jnp.argmin(vals)], jnp.min(vals)
    cand = z_best[None, :] + 1.2 * jnp.asarray(jhalton(n_zoom, 4, start=17)
                                               - 0.5)
    vals = neg_logpost(cand)
    i = jnp.argmin(vals)
    z_map = jnp.where(vals[i] < v_best, cand[i], z_best)
    out = jlogpost(spec, x, y, sigma2, theta1_prior=ln_prior,
                   theta2_prior=ig_prior, jitter=JITTER)(z_map)
    params, _ = unpack(spec, z_map)
    v = jlin.tri_solve(out.chol, mixed_cross(spec, x, grid, params))
    a = jlin.tri_solve(out.chol, y - out.beta)
    u = jlin.tri_solve(out.chol, jnp.ones_like(y))
    mean = out.beta + jnp.einsum("n,nt->t", a, v)
    var = sigma2 * (1.0 - jnp.einsum("nt,nt->t", v, v)
                    + (1.0 - jnp.einsum("n,nt->t", u, v)) ** 2
                    / jnp.sum(u * u))
    return {"mean": mean, "var": var, "z_map": z_map, "sigma2": sigma2}


def test_map_program_matches_jax():
    x = np.random.default_rng(0).uniform(size=(20, 2))
    y = chip_smoke.f2(x)
    u = np.linspace(0, 1, 7)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    want = jax_map_program(jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid),
                           64, 64)
    before = chol_lanes.chol_quadratics_lanes.launches
    got = chip_smoke.map_fit_predict(
        *(torch.tensor(a, dtype=torch.float64) for a in (x, y, grid)),
        n_cloud=64, n_zoom=64, jitter=JITTER)
    assert chol_lanes.chol_quadratics_lanes.launches == before   # CPU: twin
    for k in ("sigma2", "z_map", "mean", "var"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        err = np.max(np.abs(g - w) / np.maximum(1.0, np.abs(w)))
        assert err <= 1e-9, (k, err)
