"""The factor cache's lanes branch and the draw-chunked (lazy) predict
against the JAX package, float64 on the CPU.

Tolerances, relative to max(1, |value|):
- `build_factors` at m = 64 (the lanes factor kernel's plain twin) against
  JAX's vmapped Cholesky + solves: 1e-9 (two factorizations that round
  differently, Grams with jitter 1e-6);
- the lazy predict against JAX's at draw_chunk 7 over 30 draws: chain
  counters equal, mean / lower / upper 1e-6 (the Laplace mode agrees to
  ~1e-7, the BFGS stopping tolerance; see test_torch_combined_gp.py);
- the port's lazy predict against its own stash-decoded cache: 1e-8 (the
  stash holds the rounds kernel's factors, the lazy path refactors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccgp_tpu.predict.factors as jfactors
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import fit_combined_gp as jfit
from ccgp_tpu.models import predict_combined_gp as jpredict
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.ops import chol_lanes, kernels as tkern, rng
from ccgp_tpu_torch.predict import factors
from ccgp_tpu_torch.predict.posterior import (
    predictive_moments, predictive_moments_lazy)

CFG = dict(start=(1.0, 1.0, 0.0), n_max=200, samp_size=50,
           net_samp_size=30, speculative=4)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def assert_close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def specs():
    return (JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
            TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2))


@pytest.fixture
def spy_factors(monkeypatch):
    calls = []
    real = chol_lanes.chol_factors_lanes

    def spy(grams, y, jitter=0.0):
        calls.append(tuple(grams.shape))
        return real(grams, y, jitter=jitter)

    monkeypatch.setattr(chol_lanes, "chol_factors_lanes", spy)
    return calls


@pytest.mark.parametrize("m,routed", [(64, True), (63, False)])
def test_build_factors_matches_jax(spy_factors, m, routed):
    r = np.random.default_rng(m)
    x = r.uniform(size=(17, 2))
    y = np.sin(5 * x[:, 0]) + x[:, 1]
    zs = r.normal(size=(m, 3)) * 0.4
    betas = r.normal(size=m) * 0.05
    js, ts = specs()
    want = jfactors.build_factors(js, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(zs), jnp.asarray(betas),
                                  jitter=1e-6)
    got = factors.build_factors(ts, t(x), t(y), t(zs), t(betas), jitter=1e-6)
    assert spy_factors == ([(m, 17, 17)] if routed else [])
    for f in ("chol", "a", "u", "beta"):
        assert_close(getattr(got, f), getattr(want, f), 1e-9)


@pytest.fixture(scope="module")
def lazy_problem():
    r = np.random.default_rng(0)
    return (r.uniform(size=(24, 2)), r.normal(size=24),
            r.uniform(size=(17, 2)))


def test_lazy_predict_matches_jax(lazy_problem):
    x, y, xt = lazy_problem
    js, ts = specs()

    def run_jax(x, y, xt, key):
        kf, kp = jax.random.split(key)
        fit = jfit(js, x, y, kf, mcmc=JCfg(**CFG), jitter=1e-6,
                   mle_method="grid", draw_chunk=7)
        return fit, jpredict(js, fit, x, xt, kp, draw_chunk=7)

    jf, jp = jax.jit(run_jax)(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(xt), jax.random.PRNGKey(3))
    kf, kp = rng.split(rng.PRNGKey(3, device="cpu"), 2)
    tf = fit_combined_gp(ts, t(x), t(y), kf, mcmc=MCMCConfig(**CFG),
                         jitter=1e-6, mle_method="grid", draw_chunk=7,
                         device="cpu")
    assert tf.cache.chol.shape == (0, 24, 24)    # nothing materialized
    assert tf.mcmc.n_recorded == int(jf.mcmc.n_recorded)
    assert tf.mcmc.n_proposals == int(jf.mcmc.n_proposals)
    tp = predict_combined_gp(ts, tf, t(x), t(xt), kp, draw_chunk=7,
                             device="cpu")
    for f in ("mean", "lower", "upper"):
        assert_close(getattr(tp, f), getattr(jp, f), 1e-6)
    # the same chain and draws as the stash path, predicting the same
    classic = fit_combined_gp(ts, t(x), t(y), kf, mcmc=MCMCConfig(**CFG),
                              jitter=1e-6, mle_method="grid", device="cpu")
    assert torch.equal(classic.zs, tf.zs)
    cp = predict_combined_gp(ts, classic, t(x), t(xt), kp, device="cpu")
    for f in ("mean", "lower", "upper", "quant", "draw_mean", "draw_var"):
        assert_close(getattr(tp, f), getattr(cp, f), 1e-8)
    # a fit without its y cannot rebuild factors
    with pytest.raises(ValueError, match="lazy factor cache"):
        predict_combined_gp(ts, tf._replace(y=None), t(x), t(xt), kp,
                            device="cpu")


@pytest.mark.parametrize("m,chunk,shapes", [
    (130, 64, [(64, 24, 24)] * 3),   # ragged tail padded to a full chunk
    (30, 7, []),                     # chunks below 64 take the plain path
])
def test_lazy_moments_chunk_and_pad(spy_factors, lazy_problem, m, chunk,
                                    shapes):
    x, y, xt = lazy_problem
    _, ts = specs()
    r = np.random.default_rng(1)
    zs, betas = t(r.normal(size=(m, 3)) * 0.4), t(r.normal(size=m) * 0.05)
    dm, dv = predictive_moments_lazy(ts, t(x), t(y), t(xt), zs, betas, 0.7,
                                     jitter=1e-6, draw_chunk=chunk)
    assert spy_factors == shapes
    assert dm.shape == dv.shape == (m, 17)
    whole = factors.build_factors(ts, t(x), t(y), zs, betas, jitter=1e-6)
    wm, wv = predictive_moments(ts, whole, t(x), t(xt), 0.7)
    assert_close(dm, wm, 1e-8)
    assert_close(dv, wv, 1e-8)
