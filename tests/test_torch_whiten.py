"""`whiten=True`, the cancellation-free quadratic, on the CPU, float64,
against the JAX package: `make_logpost`, `make_logpost_batch`,
`make_mh_round` and `make_mh_rounds` at the same inputs, the routing
(no fused kernel, no stash) and `fit_combined_gp(whiten=True)` end to end.

Tolerances: deterministic math at the same inputs 1e-10 relative to
max(1, |value|), -inf in the same places, acceptance flags and counts
equal. The fit: JAX takes its one-round body on the CPU and the port the
chunked driver; the two are law-equal, so with the same key the chain
counters are equal, and sigma2 agrees to 1e-8 and the draws and
predictions to 1e-6 (`tests/test_torch_combined_gp.py`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import fit_combined_gp as jfit
from ccgp_tpu.models import predict_combined_gp as jpredict
from ccgp_tpu.models import likelihood as jlik
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.models import likelihood as tlik
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import kernels as tkern, rng
from ccgp_tpu_torch.predict.factors import build_factors


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, ref, tol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    ok = np.isfinite(ref)
    err = np.abs(got[ok] - ref[ok]) / np.maximum(1.0, np.abs(ref[ok]))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def specs(kind):
    """(JAX spec, port spec, start, JAX priors, port priors)."""
    if kind == "iso":
        return (JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
                TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2),
                (1.0, 1.0, 0.0),
                dict(theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16)),
                dict(theta1_prior=InverseGamma(3, 2),
                     theta2_prior=InverseGamma(5, 16)))
    return (JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2,
                  rough="tied", anisotropic=True),
            TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                  rough="tied", anisotropic=True),
            (1.0, 1.0, 0.0, 0.0),
            dict(theta1_prior=JLN(-1.0, 1.0), theta2_prior=JIG(3, 4)),
            dict(theta1_prior=LogNormal(-1.0, 1.0),
                 theta2_prior=InverseGamma(3, 4)))


def problem(seed, n=12, offset=0.0):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    y = offset + np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1]) + 0.1 * r.normal(
        size=n)
    return x, y, r


@pytest.fixture
def no_fused_kernels(monkeypatch):
    """Every fused kernel of the likelihood raises if it is reached."""
    def refuse(*_, **__):
        raise AssertionError("whiten=True reached a fused kernel")

    for name in ("fused_mix_mh_rounds", "fused_mix_mh_round",
                 "fused_mix_quadratics_smallk"):
        monkeypatch.setattr(tlik, name, refuse)


@pytest.mark.parametrize("kind", ["iso", "aniso"])
@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_logpost_and_batch_match_jax(kind, offset, no_fused_kernels):
    jspec, tspec, start, jpri, tpri = specs(kind)
    x, y, r = problem(1, offset=offset)
    zs = r.normal(size=(5, len(start))) * 0.5
    # jitter 1e-6 keeps R's condition number near 1e6: at 1e-10 the
    # two Cholesky implementations part by ~1e-9 on the same Gram
    kw = dict(jitter=1e-6, whiten=True)
    jlp = jlik.make_logpost(jspec, jnp.asarray(x), jnp.asarray(y), 1.3,
                            **jpri, **kw)
    tlp = tlik.make_logpost(tspec, t(x), t(y), t(1.3), **tpri, **kw)
    for z in zs:
        a, b = jlp(jnp.asarray(z)), tlp(t(z))
        close(b.val, a.val)
        close(b.beta, a.beta)
        close(b.chol, a.chol)
    jv, jb = jlik.make_logpost_batch(jspec, jnp.asarray(x), jnp.asarray(y),
                                     1.3, **jpri, **kw)(jnp.asarray(zs))
    tv, tb = tlik.make_logpost_batch(tspec, t(x), t(y), t(1.3), **tpri,
                                     **kw)(t(zs))
    close(tv, jv)
    close(tb, jb)


def test_whiten_matches_bordered(no_fused_kernels):
    """The case of `tests/test_models.py:168-185` in the port: in f64 at a
    small n the whitened and bordered log-posteriors agree to round-off,
    and the batched evaluator agrees with the single one."""
    _, tspec, _, _, tpri = specs("iso")
    x, y, r = problem(0)
    kw = dict(jitter=1e-10, **tpri)
    lp = tlik.make_logpost(tspec, t(x), t(y), t(1.3), **kw)
    lp_w = tlik.make_logpost(tspec, t(x), t(y), t(1.3), whiten=True, **kw)
    zs = t(r.normal(size=(5, 3)) * 0.5)
    vals_w, betas_w = tlik.make_logpost_batch(tspec, t(x), t(y), t(1.3),
                                              whiten=True, **kw)(zs)
    for i, z in enumerate(zs):
        a, b = lp(z), lp_w(z)
        close(b.val, a.val, 1e-9)
        close(b.beta, a.beta, 1e-9)
        close(vals_w[i], a.val, 1e-9)
        close(betas_w[i], a.beta, 1e-9)


def test_singular_gram_is_neg_inf(no_fused_kernels):
    _, tspec, _, jpri, tpri = specs("iso")
    jspec = specs("iso")[0]
    x = np.zeros((5, 2))                       # identical points: singular R
    y = np.arange(5.0)
    z = np.array([0.0, 1.0, 0.0])
    out = tlik.make_logpost(tspec, t(x), t(y), t(1.0), whiten=True)(t(z))
    assert float(out.val) == -math.inf
    zs = np.stack([z, z + 0.1])
    tv, tb = tlik.make_logpost_batch(tspec, t(x), t(y), t(1.0), whiten=True,
                                     **tpri)(t(zs))
    jv, jb = jlik.make_logpost_batch(jspec, jnp.asarray(x), jnp.asarray(y),
                                     1.0, whiten=True, **jpri)(
                                         jnp.asarray(zs))
    assert bool(torch.isneginf(tv).all())
    close(tv, jv)


@pytest.mark.parametrize("kind", ["iso", "aniso"])
def test_mh_round_matches_jax(kind, no_fused_kernels):
    jspec, tspec, start, jpri, tpri = specs(kind)
    x, y, r = problem(2)
    kk = 4
    kw = dict(jitter=1e-8, whiten=True)
    jround = jlik.make_mh_round(jspec, jnp.asarray(x), jnp.asarray(y), 0.7,
                                **jpri, **kw)
    tround = tlik.make_mh_round(tspec, t(x), t(y), t(0.7), **tpri, **kw)
    z = np.asarray(start)
    jlp = jlik.make_logpost(jspec, jnp.asarray(x), jnp.asarray(y), 0.7,
                            **jpri, **kw)(jnp.asarray(z))
    for trial in range(4):
        cands = z + 0.3 * r.normal(size=(kk, len(start)))
        log_u = np.log(r.uniform(size=kk)) - (3.0 if trial % 2 else 0.0)
        a = jround(jnp.asarray(z), jlp.val, jlp.beta, jnp.asarray(cands),
                   jnp.asarray(log_u))
        b = tround(t(z), t(jlp.val), t(jlp.beta), t(cands), t(log_u))
        for ga, gb in zip(a[:3], b[:3]):
            close(gb, ga)
        assert bool(b[3]) == bool(a[3]) and int(b[4]) == int(a[4])


@pytest.mark.parametrize("kind", ["iso", "aniso"])
def test_mh_rounds_match_jax(kind, no_fused_kernels):
    """R = 6 rounds of K = 4 from the same deltas and thresholds: JAX on
    the CPU scans its whitened batched evaluator, as the port loops it."""
    jspec, tspec, start, jpri, tpri = specs(kind)
    x, y, r = problem(3)
    rr, kk, dim = 6, 4, len(start)
    kw = dict(jitter=1e-8, whiten=True)
    z = np.asarray(start)
    jlp = jlik.make_logpost(jspec, jnp.asarray(x), jnp.asarray(y), 0.7,
                            **jpri, **kw)(jnp.asarray(z))
    deltas = 0.3 * r.normal(size=(rr * kk, dim))
    log_u = np.log(r.uniform(size=(rr, kk))) - 1.0
    a = jlik.make_mh_rounds(jspec, jnp.asarray(x), jnp.asarray(y), 0.7,
                            **jpri, **kw)(
        jnp.asarray(z), jlp.val, jlp.beta, jnp.asarray(deltas),
        jnp.asarray(log_u))
    b = tlik.make_mh_rounds(tspec, t(x), t(y), t(0.7), **tpri, **kw)(
        t(z), t(jlp.val), t(jlp.beta), t(deltas), t(log_u))
    for f in ("rec", "z_fin", "val_fin", "beta_fin"):
        close(b[f], a[f])
    assert np.array_equal(b["acc"].numpy(), np.asarray(a["acc"]))
    assert np.array_equal(b["consumed"].numpy(), np.asarray(a["consumed"]))


def test_stash_under_whiten_raises():
    _, tspec, start, _, tpri = specs("aniso")
    x, y, _ = problem(4)
    rounds = tlik.make_mh_rounds(tspec, t(x), t(y), t(0.7), stash=True,
                                 whiten=True, **tpri)
    with pytest.raises(ValueError, match="whiten"):
        rounds(t(start), t(0.0), t(0.0), torch.zeros((8, 4),
                                                     dtype=torch.float64),
               torch.zeros((2, 4), dtype=torch.float64))


# ---------------------------------------------------------------------------
# fit_combined_gp(whiten=True) end to end, against JAX
# ---------------------------------------------------------------------------

CFG = dict(start=(1.0, 1.0, 0.0, 0.0), n_max=150, samp_size=60,
           net_samp_size=60, speculative=4)


@pytest.fixture(scope="module")
def fit_data():
    """The data of `tests/test_models.py:188-210`."""
    r = np.random.default_rng(0)
    x = r.uniform(size=(16, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    u = np.linspace(0, 1, 5)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    return x, y, grid


@pytest.fixture(scope="module")
def jax_fit(fit_data):
    x, y, grid = fit_data
    jspec, _, _, jpri, _ = specs("aniso")
    kf, kp = jax.random.split(jax.random.PRNGKey(2))
    fit = jfit(jspec, jnp.asarray(x), jnp.asarray(y), kf, mcmc=JCfg(**CFG),
               jitter=1e-9, mle_method="grid", whiten=True, **jpri)
    return fit, jpredict(jspec, fit, jnp.asarray(x), jnp.asarray(grid), kp)


def test_fit_whiten_matches_jax(fit_data, jax_fit, monkeypatch):
    x, y, grid = fit_data
    _, tspec, _, _, tpri = specs("aniso")
    for name in ("fused_mix_mh_rounds", "fused_mix_mh_round",
                 "fused_mix_quadratics_smallk"):
        monkeypatch.setattr(tlik, name, None)       # unreachable
    kf, kp = rng.split(rng.PRNGKey(2, device="cpu"), 2)
    tf = fit_combined_gp(tspec, t(x), t(y), kf, mcmc=MCMCConfig(**CFG),
                         jitter=1e-9, mle_method="grid", whiten=True,
                         device="cpu", **tpri)
    tp = predict_combined_gp(tspec, tf, t(x), t(grid), kp, device="cpu")
    jf, jp = jax_fit
    assert tf.mcmc.factors is None                  # no stash
    for a in ("n_recorded", "n_proposals", "n_rounds", "n_accepted"):
        assert getattr(tf.mcmc, a) == int(getattr(jf.mcmc, a)), a
    assert tf.mcmc.converged == bool(jf.mcmc.converged)
    assert tf.chain_ok == bool(jf.chain_ok)
    assert tf.mcmc.n_recorded > 0
    close(tf.sigma2, jf.sigma2, 1e-8)
    close(tf.zs, jf.zs, 1e-6)
    close(tf.cache.chol, jf.cache.chol, 1e-6)
    for f in ("mean", "lower", "upper"):
        close(getattr(tp, f), getattr(jp, f), 1e-6)
    # the cache is the one `build_factors` makes from the retained draws
    ref = build_factors(tspec, t(x), t(y), tf.zs, tf.cache.beta, jitter=1e-9)
    for f in ("chol", "a", "u"):
        close(getattr(tf.cache, f), getattr(ref, f))
