"""`infer/hmc.py` against the JAX package, float64 on the CPU.

HMC amplifies a last-place difference: each trajectory's 8-16 leapfrog
steps carry it, and during warmup the dual averaging feeds the
acceptance back into the step size. The two packages' log-posteriors
and gradients agree to ~1e-14 (`torch.autograd` against `jax.grad`) but
not bit for bit, so the chains part, exponentially, after ~20 warmup
iterations (the Gaussian target: 7.6e-12 after 10 warmup and 40 sampling
iterations, 4.0e-8 after 20 and 40; with no warmup, 100 sampling
iterations stay within 5e-15). The parity tests therefore run 10 warmup
iterations and 40 draws, or 100 draws with none: samples and
log-posteriors within 1e-8, the step size within 1e-10, equal divergence
counts. Longer runs are held to the target distribution (the JAX tests'
oracles), and c chains in one call to their c single runs within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.infer.hmc import hmc as jhmc
from ccgp_tpu.infer.laplace import laplace as jlaplace
from ccgp_tpu.models import InverseGamma as JIG, MixtureSpec as JSpec
from ccgp_tpu.models import make_logpost as jlogpost
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.infer.hmc import HMCResult, _leapfrog, hmc
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.likelihood import make_logpost
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng


def _gauss(z):
    return -0.5 * (z * z).sum(-1)


@pytest.fixture(scope="module")
def gp():
    g = np.random.default_rng(0)
    x = g.uniform(size=(10, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    jl = jlogpost(JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
                  jnp.asarray(x), jnp.asarray(y), 0.5,
                  theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16),
                  jitter=1e-6)
    tl = make_logpost(TSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                            dim=2), torch.tensor(x), torch.tensor(y), 0.5,
                      theta1_prior=InverseGamma(3, 2),
                      theta2_prior=InverseGamma(5, 16), jitter=1e-6)
    fit = jlaplace(lambda z: jl(z).val, jnp.asarray([0.5, 1.0, 0.0]))
    return dict(jlp=lambda z: jl(z).val, tlp=lambda z: tl(z).val,
                mode=np.asarray(fit.mode), cov=np.asarray(fit.cov))


def _both(gp, target, **kw):
    if target == "gauss":
        jf, tf, start, cov = _gauss, _gauss, np.array([0.5, 0.0]), None
    else:
        jf, tf, start, cov = gp["jlp"], gp["tlp"], gp["mode"], gp["cov"]
    jr = jhmc(jf, jnp.asarray(start), jax.random.PRNGKey(3),
              mass_cov=None if cov is None else jnp.asarray(cov), **kw)
    tr = hmc(tf, torch.tensor(start), rng.PRNGKey(3, device="cpu"),
             mass_cov=None if cov is None else torch.tensor(cov), **kw)
    return jr, tr


@pytest.mark.parametrize("n_warmup,n_samples", [(10, 40), (0, 100)])
@pytest.mark.parametrize("target", ["gauss", "gp"])
def test_hmc_matches_jax(gp, target, n_warmup, n_samples):
    jr, tr = _both(gp, target, n_samples=n_samples, n_warmup=n_warmup,
                   n_leapfrog=16)
    assert isinstance(tr, HMCResult)
    assert tr.samples.shape == np.asarray(jr.samples).shape
    np.testing.assert_allclose(tr.samples.numpy(), np.asarray(jr.samples),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr.logposts.numpy(), np.asarray(jr.logposts),
                               rtol=1e-8)
    assert abs(float(tr.step_size) - float(jr.step_size)) < 1e-10
    assert abs(float(tr.accept_rate) - float(jr.accept_rate)) < 1e-8
    assert int(tr.n_divergent) == int(jr.n_divergent)


def test_hmc_nan_region_matches_jax_and_is_rejected():
    """Trajectories that enter a NaN region are divergences: rejected,
    never recorded; JAX counts the same ones over a short run."""
    def jlp(z):
        return jnp.where(jnp.all(jnp.abs(z) < 2.5), -0.5 * jnp.sum(z * z),
                         jnp.nan)

    def tlp(z):
        return torch.where(torch.all(torch.abs(z) < 2.5, dim=-1),
                           -0.5 * (z * z).sum(-1),
                           torch.full_like(z[..., 0], float("nan")))

    kw = dict(n_warmup=10, n_samples=40, n_leapfrog=8, init_step_size=0.5)
    jr = jhmc(jlp, jnp.zeros(2), jax.random.PRNGKey(2), **kw)
    tr = hmc(tlp, torch.zeros(2, dtype=torch.float64),
             rng.PRNGKey(2, device="cpu"), **kw)
    assert int(tr.n_divergent) == int(jr.n_divergent)
    np.testing.assert_allclose(tr.samples.numpy(), np.asarray(jr.samples),
                               rtol=0, atol=1e-8)
    res = hmc(tlp, torch.zeros(2, dtype=torch.float64),
              rng.PRNGKey(2, device="cpu"), n_samples=2000, n_warmup=200,
              n_leapfrog=8, init_step_size=0.5)
    zs = res.samples.numpy()
    assert int(res.n_divergent) > 0
    assert np.all(np.isfinite(zs)) and np.all(np.abs(zs) < 2.5)
    assert np.all(np.isfinite(res.logposts.numpy()))


def test_singular_gram_gives_a_nan_gradient_and_a_divergence():
    """Rates so small that the Gram is all ones (no jitter) fail the
    factorization:
    the log-posterior is -inf and its gradient NaN, without raising, and
    a chain started beside it records only finite draws."""
    g = np.random.default_rng(0)
    x = torch.tensor(g.uniform(size=(10, 2)))
    lp = make_logpost(TSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                            dim=2), x, torch.sin(5 * x[:, 0]), 0.5)

    def tl(z):
        return lp(z).val

    z = torch.tensor([-40.0, -40.0, 0.0], dtype=torch.float64,
                     requires_grad=True)
    val = tl(z)
    assert val.item() == -np.inf
    g, = torch.autograd.grad(val, z)
    assert not torch.all(torch.isfinite(g))
    res = hmc(tl, torch.tensor([-40.0, -40.0, 0.0], dtype=torch.float64),
              rng.PRNGKey(0, device="cpu"), n_samples=20, n_warmup=5,
              n_leapfrog=4)
    assert int(res.n_divergent) == 20 and float(res.accept_rate) == 0.0


def test_leapfrog_is_exact_on_a_harmonic_oscillator():
    """One leapfrog step of the unit Gaussian from (u, p) = (1, 0) with
    eps = 0.5: p = -0.25, u = 0.875, p = -0.25 - 0.21875."""
    def vg(u):
        return -0.5 * (u * u).sum(-1), -u

    u0 = torch.tensor([1.0], dtype=torch.float64)
    u, p, lp, g = _leapfrog(vg, u0, torch.zeros(1, dtype=torch.float64),
                            -u0, torch.tensor(0.5, dtype=torch.float64), 1)
    assert float(u) == 0.875 and float(p) == -0.46875
    assert float(g) == -0.875 and float(lp) == -0.5 * 0.875 ** 2


def test_hmc_gaussian_moments_preconditioned():
    """A correlated Gaussian with its covariance as mass_cov (the JAX
    test's oracle): the draws' mean and covariance within MC error."""
    mu = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    a = torch.tensor([[2.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 0.8]],
                     dtype=torch.float64)
    cov = a @ a.T
    prec = torch.linalg.inv(cov)

    def lp(z):
        d = z - mu
        return -0.5 * torch.einsum("...i,ij,...j->...", d, prec, d)

    res = hmc(lp, torch.zeros(3, dtype=torch.float64),
              rng.PRNGKey(0, device="cpu"), n_samples=3000, n_warmup=300,
              n_leapfrog=8, mass_cov=cov)
    zs = res.samples.numpy()
    assert int(res.n_divergent) == 0
    assert 0.6 < float(res.accept_rate) <= 1.0
    assert np.allclose(zs.mean(0), mu.numpy(), atol=0.15)
    assert np.allclose(np.cov(zs.T), cov.numpy(), atol=0.5)


def test_hmc_dual_averaging_adapts_identity_mass():
    """Variances 1 and 100 with identity mass (the JAX test's oracle):
    acceptance near the target, both scales recovered."""
    var = torch.tensor([1.0, 100.0], dtype=torch.float64)

    def lp(z):
        return -0.5 * (z * z / var).sum(-1)

    res = hmc(lp, torch.zeros(2, dtype=torch.float64),
              rng.PRNGKey(1, device="cpu"), n_samples=4000, n_warmup=800,
              n_leapfrog=32)
    assert np.isfinite(float(res.step_size)) and float(res.step_size) > 0
    assert 0.6 < float(res.accept_rate) <= 0.95
    zs = res.samples.numpy()
    assert abs(zs[:, 0].std() - 1.0) < 0.25
    assert abs(zs[:, 1].std() - 10.0) < 2.5


@pytest.mark.parametrize("target", ["gauss", "gp"])
def test_hmc_chains_are_their_single_runs(gp, target):
    """(c, dim) starts and (c, 2) keys: chain i is hmc(start_i, key_i)."""
    if target == "gauss":
        lp, cov = _gauss, None
        starts = torch.tensor([[0.5, 0.0], [-0.5, 0.2], [0.0, -0.3]],
                              dtype=torch.float64)
    else:
        lp, cov = gp["tlp"], torch.tensor(gp["cov"])
        starts = torch.tensor(gp["mode"])[None] + torch.tensor(
            [[0.0, 0.0, 0.0], [0.1, -0.1, 0.05], [-0.2, 0.1, 0.0]],
            dtype=torch.float64)
    keys = rng.split(rng.PRNGKey(5, device="cpu"), 3)
    kw = dict(n_samples=60, n_warmup=60, n_leapfrog=8, mass_cov=cov)
    res = hmc(lp, starts, keys, **kw)
    assert res.samples.shape == (3, 60, starts.shape[1])
    assert res.step_size.shape == (3,) and res.n_divergent.shape == (3,)
    for i in range(3):
        one = hmc(lp, starts[i], keys[i], **kw)
        np.testing.assert_allclose(res.samples[i].numpy(),
                                   one.samples.numpy(), rtol=0, atol=1e-12)
        assert abs(float(res.step_size[i]) - float(one.step_size)) < 1e-12
        assert int(res.n_divergent[i]) == int(one.n_divergent)


def test_hmc_chains_match_jax_vmap():
    """c chains against `jax.vmap(hmc)` on the same keys (short run)."""
    starts = np.array([[0.5, 0.0], [-0.5, 0.2], [0.0, -0.3]])
    kw = dict(n_samples=40, n_warmup=10, n_leapfrog=8)
    jkeys = jax.random.split(jax.random.PRNGKey(5), 3)
    jr = jax.vmap(lambda s, k: jhmc(_gauss, s, k, **kw))(
        jnp.asarray(starts), jkeys)
    tr = hmc(_gauss, torch.tensor(starts),
             rng.split(rng.PRNGKey(5, device="cpu"), 3), **kw)
    np.testing.assert_allclose(tr.samples.numpy(), np.asarray(jr.samples),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr.step_size.numpy(),
                               np.asarray(jr.step_size), rtol=0, atol=1e-10)
