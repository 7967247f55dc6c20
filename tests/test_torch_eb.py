"""The empirical-Bayes pieces — `ops/special.py`, `eb/halton.py`,
`eb/hyperpriors.py` — against the JAX package (and scipy), float64 on the
CPU.

Tolerances: gammaincinv and the inverse-gamma quantile 1e-10 relative to
JAX (both run the same fixed Newton iteration; torch's and XLA's
`gammainc` differ in the last places); Halton nodes equal; log marginal
likelihoods 1e-9 relative (node sweeps of 64 go through the lanes
kernel's plain twin, of 32 through the bordered path, while JAX on the
CPU always takes its bordered path; the two factorizations round
differently); the chosen grid row equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch

from ccgp_tpu.eb import choose_hyperpars as jchoose
from ccgp_tpu.eb import halton as jhalton
from ccgp_tpu.eb import marginal_likelihood as jml
from ccgp_tpu.models import MixtureSpec as JSpec
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu.ops.special import gammaincinv as jgammaincinv
from ccgp_tpu.ops.special import invgamma_quantile as jinvgamma_quantile
from ccgp_tpu_torch.eb import choose_hyperpars, halton, marginal_likelihood
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.ops import chol_lanes, kernels as tkern
from ccgp_tpu_torch.ops.special import gammaincinv, invgamma_quantile


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref) / np.maximum(1.0, np.abs(ref))))


@pytest.mark.parametrize("a", [0.5, 1.0, 3.0, 7.0, 20.0])
def test_gammaincinv_matches_jax_and_scipy(a):
    q = np.linspace(0.001, 0.999, 50)
    got = gammaincinv(a, t(q)).numpy()
    assert rel(got, jgammaincinv(a, jnp.asarray(q))) <= 1e-10
    assert np.allclose(got, sps.gammaincinv(a, q), rtol=1e-10)


@pytest.mark.parametrize("a,b", [(3.0, 2.0), (5.0, 16.0), (7.0, 3.0)])
def test_invgamma_quantile_matches_jax(a, b):
    p = np.linspace(0.01, 0.99, 30)
    got = invgamma_quantile(t(p), a, b)
    assert rel(got, jinvgamma_quantile(jnp.asarray(p), a, b)) <= 1e-10
    # tensor hyperparameters (a grid row on the device) give the same
    assert torch.equal(invgamma_quantile(t(p), t(a), t(b)), got)


@pytest.mark.parametrize("n,d,start", [(8, 1, 1), (1728, 1, 1), (128, 4, 1),
                                       (64, 4, 17)])
def test_halton_equals_jax(n, d, start):
    assert np.array_equal(halton(n, d, start), jhalton(n, d, start))


def eb_problem(n=12, seed=0):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    return x, np.sin(4 * x[:, 0]) + x[:, 1] ** 2 + 0.1 * r.normal(size=n)


@pytest.mark.parametrize("n_nodes", [64, 32])
def test_marginal_likelihood_matches_jax(monkeypatch, n_nodes):
    calls = []
    real = chol_lanes.chol_quadratics_lanes

    def spy(grams, y, jitter=0.0):
        calls.append(tuple(grams.shape))
        return real(grams, y, jitter=jitter)

    monkeypatch.setattr(chol_lanes, "chol_quadratics_lanes", spy)
    x, y = eb_problem()
    nodes = halton(n_nodes, 1)[:, 0]
    js = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
    ts = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
    for a1, b1, a2, b2 in [(3.0, 2.0, 5.0, 16.0), (3.0, 4.0, 5.0, 55.0)]:
        want = float(jml(js, jnp.asarray(x), jnp.asarray(y), (a1, b1),
                         (a2, b2), 1.3, jnp.asarray(nodes), tau=50.0))
        got = marginal_likelihood(ts, t(x), t(y), (a1, b1), (a2, b2), 1.3,
                                  t(nodes), tau=50.0)
        assert np.isfinite(want) and rel(got, want) <= 1e-9
    assert calls == ([(64, 12, 12)] * 2 if n_nodes >= 64 else [])


def test_choose_hyperpars_matches_jax():
    x, y = eb_problem(14, seed=2)
    grid = np.array([[3.0, 4.0, 5.0, 55.0], [30.0, 1.0, 30.0, 1.0],
                     [3.0, 8.0, 5.0, 30.0], [3.0, 16.0, 3.0, 64.0]])
    js = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
    ts = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
    want = jchoose(js, jnp.asarray(x), jnp.asarray(y), grid, 0.8,
                   n_nodes=128, tau=100.0)
    got = choose_hyperpars(ts, x, y, grid, 0.8, n_nodes=128, tau=100.0,
                           device="cpu")
    assert int(got.index) == int(want.index)
    # row 1's rates (~0.03 on the unit square) make every node's
    # covariance singular to roundoff (tau^2 J dominates, jitter 0): its
    # value is roundoff in both packages (~-2e9), so only its rank (last)
    # is held
    ok = np.array([True, False, True, True])
    assert rel(got.likelihoods[ok], np.asarray(want.likelihoods)[ok]) <= 1e-9
    assert int(torch.argmin(got.likelihoods)) == 1
    assert np.array_equal(got.pars.numpy(), grid[int(want.index)])
    assert got.likelihoods.device.type == "cpu"
