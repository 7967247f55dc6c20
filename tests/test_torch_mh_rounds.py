"""The fused Metropolis rounds and the chunked driver of the port against
the JAX package, float64 on the CPU.

The problem is `tests/test_mh_rounds.py`'s (n = 16, 2-D anisotropic SE x SE
with tied rough rates, sigma2 = 0.05, jitter 1e-9, R = 6, K = 4).

Tolerances: acceptance flags, consumed counts and chain counters are
equal. Records and decoded stash: <= 1e-9 relative to max(1, |value|).
The jitter-1e-9 Gram amplifies float64 roundoff by ~1e7, and JAX's own
kernel and fallback differ by the same order; log-posteriors are O(100).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccgp_tpu.models.likelihood as jlik
import ccgp_tpu.ops.pallas_chol_smallk as jsk
from ccgp_tpu.infer.laplace import laplace as jlaplace
from ccgp_tpu.infer.metropolis import metropolis as jmetropolis
from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN
from ccgp_tpu.models import JeffreysUnit as JJU, Uniform01 as JU01
from ccgp_tpu.models import MixtureSpec as JSpec, make_logpost as jlogpost
from ccgp_tpu.models.combination import mixed_gram as jmixed_gram
from ccgp_tpu.models.combination import unpack as junpack
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu.ops import linalg as jlin
from ccgp_tpu.predict.factors import decode_stash as jdecode
from ccgp_tpu_torch.infer.metropolis import metropolis
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.convert import key_from_numpy, laplace_from_numpy
from ccgp_tpu_torch.models.likelihood import (
    cand_model_for, make_logpost, make_mh_rounds)
from ccgp_tpu_torch.models.priors import (
    InverseGamma, JeffreysUnit, LogNormal, Uniform01)
from ccgp_tpu_torch.ops import chol_smallk, kernels as tkern
from ccgp_tpu_torch.predict.factors import decode_stash

TOL = 1e-9
START = np.array([1.0, 1.0, 0.0, 0.0])


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def assert_close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(16, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    js = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2,
               rough="tied", anisotropic=True)
    ts = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
               rough="tied", anisotropic=True)
    jkw = dict(theta1_prior=JLN(-1, 1), theta2_prior=JIG(3, 4), jitter=1e-9)
    tkw = dict(theta1_prior=LogNormal(-1, 1), theta2_prior=InverseGamma(3, 4),
               jitter=1e-9)
    return x, y, js, ts, jkw, tkw


def _round_inputs(seed):
    rng = np.random.default_rng(seed)
    R, K, dim = 6, 4, 4
    return dict(z=np.array([0.6, 0.4, 0.1, -0.2]),
                deltas=0.25 * rng.normal(size=(R * K, dim)),
                log_u=np.log(rng.uniform(size=(R, K))))


def _jax_kernel_interpret(js, x, y, s2, jkw, inp):
    """JAX's fused rounds kernel in interpret mode, reached through
    make_mh_rounds' TPU branch (the spy pattern of test_mh_rounds.py)."""
    orig, orig_backend = jsk.fused_mix_mh_rounds, jax.default_backend

    def spy(*args, **kws):
        return orig(*args, **dict(kws, interpret=True))

    jsk.fused_mix_mh_rounds = spy
    try:
        fn = jlik.make_mh_rounds(js, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(s2), stash=True, **jkw)
        jax.default_backend = lambda: "tpu"
        try:
            return fn(jnp.asarray(inp["z"]), jnp.asarray(-1e6),
                      jnp.asarray(0.0), jnp.asarray(inp["deltas"]),
                      jnp.asarray(inp["log_u"]))
        finally:
            jax.default_backend = orig_backend
    finally:
        jsk.fused_mix_mh_rounds = orig


@pytest.mark.parametrize("seed", [2, 5])
def test_rounds_plain_matches_jax(problem, seed):
    x, y, js, ts, jkw, tkw = problem
    inp = _round_inputs(seed)
    s2 = 0.05
    ref = jlik.make_mh_rounds(js, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(s2), **jkw)(
        jnp.asarray(inp["z"]), jnp.asarray(-1e6), jnp.asarray(0.0),
        jnp.asarray(inp["deltas"]), jnp.asarray(inp["log_u"]))
    ker = _jax_kernel_interpret(js, x, y, s2, jkw, inp)
    out = make_mh_rounds(ts, t(x), t(y), t(s2), stash=True, **tkw)(
        t(inp["z"]), t(-1e6), t(0.0), t(inp["deltas"]), t(inp["log_u"]))
    for other in (ref, ker):
        np.testing.assert_array_equal(out["acc"].numpy(), np.asarray(other["acc"]))
        np.testing.assert_array_equal(out["consumed"].numpy(),
                                      np.asarray(other["consumed"]))
        assert_close(out["rec"], other["rec"])
        for k in ("z_fin", "val_fin", "beta_fin"):
            assert_close(out[k], other[k])
    acc = out["acc"]
    assert int(acc.sum()) >= 1
    got = decode_stash(out["stash"][acc], len(y))
    want = jdecode(jnp.asarray(np.asarray(ker["stash"])[acc.numpy()]), len(y))
    for a, b in zip(got, want):
        assert_close(a, b)
    # and they are the accepted states' true factors
    for i, row in enumerate(out["rec"][acc].numpy()):
        p, _ = junpack(js, jnp.asarray(row[:4]))
        chol = np.asarray(jlin.jitter_cholesky(
            jmixed_gram(js, jnp.asarray(x), p), 1e-9))
        assert_close(got[0][i], chol)
    # rejected rounds' stash rows are NaN (never read)
    assert bool(torch.isnan(out["stash"][~acc]).all())


VARIANTS = {
    # isotropic, free rough rate, a flat prior on p
    "iso_free": dict(aniso=False, rough="free", K=4,
                     priors=(("IG", 3.0, 2.0), ("IG", 5.0, 16.0),
                             ("U01",))),
    # anisotropic, lambda used directly as the training rate, Jeffreys on p
    "aniso_lambda": dict(aniso=True, rough="lambda", K=4,
                         priors=(("LN", -1.0, 1.0), None, ("J",))),
    # K = 17 is outside dispatch_ok: the plain loop over batched logposts
    "outside_envelope": dict(aniso=True, rough="tied", K=17,
                             priors=(("LN", -1.0, 1.0), ("IG", 3.0, 4.0),
                                     None)),
}


def _prior_pair(p):
    if p is None:
        return None, None
    name, *args = p
    return ({"IG": JIG, "LN": JLN, "U01": JU01, "J": JJU}[name](*args),
            {"IG": InverseGamma, "LN": LogNormal, "U01": Uniform01,
             "J": JeffreysUnit}[name](*args))


@pytest.mark.parametrize("case", list(VARIANTS))
def test_rounds_variants_match_jax(problem, case):
    """Other candidate models (isotropic, free and lambda rough modes, the
    Uniform01 and Jeffreys priors) and the route outside the envelope,
    against JAX's scan fallback on the same deltas and log_u."""
    x, y, _, _, _, _ = problem
    v = VARIANTS[case]
    fam_j, fam_t = jkern.sqexp_family(), tkern.sqexp_family()
    js = JSpec(fam_j, fam_j, dim=2, rough=v["rough"], anisotropic=v["aniso"])
    ts = TSpec(fam_t, fam_t, dim=2, rough=v["rough"], anisotropic=v["aniso"])
    pj, pt = zip(*(_prior_pair(p) for p in v["priors"]))
    names = ("theta1_prior", "theta2_prior", "p_prior")
    jkw = dict(zip(names, pj), jitter=1e-9)
    tkw = dict(zip(names, pt), jitter=1e-9)
    R, K, dim = 6, v["K"], ts.n_params
    r = np.random.default_rng(13)
    z = np.array([0.6, 0.4, 0.1, -0.2][:dim])
    deltas = 0.25 * r.normal(size=(R * K, dim))
    log_u = np.log(r.uniform(size=(R, K)))
    ref = jlik.make_mh_rounds(js, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(0.05), **jkw)(
        jnp.asarray(z), jnp.asarray(-1e6), jnp.asarray(0.0),
        jnp.asarray(deltas), jnp.asarray(log_u))
    inside = chol_smallk.dispatch_ok(len(y), K)
    fn = make_mh_rounds(ts, t(x), t(y), t(0.05), stash=inside, **tkw)
    out = fn(t(z), t(-1e6), t(0.0), t(deltas), t(log_u))
    np.testing.assert_array_equal(out["acc"].numpy(), np.asarray(ref["acc"]))
    np.testing.assert_array_equal(out["consumed"].numpy(),
                                  np.asarray(ref["consumed"]))
    assert_close(out["rec"], ref["rec"])
    for k in ("z_fin", "val_fin", "beta_fin"):
        assert_close(out[k], ref[k])
    acc = out["acc"]
    assert int(acc.sum()) >= 1
    if not inside:
        assert "stash" not in out
        with pytest.raises(ValueError):
            make_mh_rounds(ts, t(x), t(y), t(0.05), stash=True, **tkw)(
                t(z), t(-1e6), t(0.0), t(deltas), t(log_u))
        return
    chol, _, _ = decode_stash(out["stash"][acc], len(y))
    for i, row in enumerate(out["rec"][acc].numpy()):
        p, _ = junpack(js, jnp.asarray(row[:dim]))
        want = np.asarray(jlin.jitter_cholesky(
            jmixed_gram(js, jnp.asarray(x), p), 1e-9))
        assert_close(chol[i], want)


def test_rounds_wrapper_checks(problem):
    x, y, js, ts, jkw, tkw = problem
    inp = _round_inputs(2)
    model = cand_model_for(ts, t(x), tkw["theta1_prior"], tkw["theta2_prior"])
    args = dict(x=t(x), y=t(y), z=t(inp["z"]), lp_val=t(-1e6), lp_beta=t(0.0),
                sigma2=t(0.05), deltas=t(inp["deltas"]),
                log_u=t(inp["log_u"]), model=model, jitter=1e-9)
    before = chol_smallk.fused_mix_mh_rounds.launches
    out = chol_smallk.fused_mix_mh_rounds(**args)
    assert chol_smallk.fused_mix_mh_rounds.launches == before   # CPU: plain
    plain = chol_smallk.fused_mix_mh_rounds_plain(**args)
    assert torch.equal(out["rec"], plain["rec"])
    with pytest.raises(ValueError):
        chol_smallk.fused_mix_mh_rounds(**dict(args, deltas=args["deltas"][1:]))
    with pytest.raises(TypeError):
        chol_smallk.fused_mix_mh_rounds(**dict(args, y=args["y"].float()))
    with pytest.raises(ValueError):   # another device: refused, not computed
        chol_smallk.fused_mix_mh_rounds(
            **{k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
               for k, v in args.items()})
    assert chol_smallk.dispatch_ok(1024, 4) and not chol_smallk.dispatch_ok(1025, 4)
    assert chol_smallk.dispatch_ok(512, 16) and not chol_smallk.dispatch_ok(512, 17)
    assert not chol_smallk.dispatch_ok(1024, 8)


@pytest.fixture(scope="module")
def laplace_fit(problem):
    x, y, js, ts, jkw, tkw = problem
    lp = jlogpost(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(0.05), **jkw)
    return jax.jit(lambda s: jlaplace(lambda z: lp(z).val, s))(
        jnp.asarray(START))


CHAINS = {
    "warm_mid_geweke": dict(seed=11, n_max=400, samp_size=120,
                            alpha_geweke=0.5, rounds_per_call_warm=48),
    "stop_truncation": dict(seed=5, n_max=400, samp_size=100,
                            alpha_geweke=1e-9),
    "proposal_cap": dict(seed=7, n_max=400, samp_size=100, alpha_geweke=0.5,
                         max_proposals=53),
    "nmax_cap": dict(seed=9, n_max=37, samp_size=20, alpha_geweke=0.9999),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_chunked_driver_matches_jax(problem, laplace_fit, case):
    """The port's chunked driver (plain fused rounds + stash on the CPU)
    against JAX's one-round speculative sampler, with the same key and the
    same Laplace fit: the same chain, draw for draw (JAX's own chunked
    driver is law-equal to it, tests/test_mh_rounds.py)."""
    x, y, js, ts, jkw, tkw = problem
    cfg = dict(CHAINS[case])
    seed = cfg.pop("seed")
    cfg.setdefault("rounds_per_call_warm", 120)
    mode = np.asarray(laplace_fit.mode)
    lpj = jlogpost(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(0.05), **jkw)
    lpbj = jlik.make_logpost_batch(js, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(0.05), **jkw)
    key = jax.random.PRNGKey(seed)
    jcfg = {k: v for k, v in cfg.items() if k != "rounds_per_call_warm"}
    rj = jax.jit(lambda k, m: jmetropolis(
        lpj, m, k, laplace_fit=laplace_fit, speculative=4,
        logpost_batch=lpbj, batch_size=20, **jcfg))(key, jnp.asarray(mode))

    lpt = make_logpost(ts, t(x), t(y), t(0.05), **tkw)
    rounds_t = make_mh_rounds(ts, t(x), t(y), t(0.05), stash=True, **tkw)
    fit_t = laplace_from_numpy(laplace_fit.mode, laplace_fit.cov,
                               laplace_fit.logpost, device="cpu")
    rt = metropolis(lpt, t(mode), key_from_numpy(key, device="cpu"),
                    laplace_fit=fit_t,
                    speculative=4, mh_rounds=rounds_t, batch_size=20,
                    stash_rows=len(y) + 2, stash_lanes=len(y), **cfg)
    n = int(rj.n_recorded)
    assert rt.n_recorded == n
    assert rt.n_proposals == int(rj.n_proposals)
    assert rt.n_accepted == int(rj.n_accepted)
    assert rt.n_rounds == int(rj.n_rounds)
    assert rt.converged == bool(rj.converged)
    assert_close(rt.samples[:n], rj.samples[:n])
    assert_close(rt.betas[:n], rj.betas[:n])
    assert_close(rt.logposts[:n], rj.logposts[:n])
    assert abs(rt.pvalue - float(rj.pvalue)) <= 1e-9
    # the stash rows land at their records' positions
    assert rt.factors_ok
    chol, _, _ = decode_stash(rt.factors[:n], len(y))
    for i in (0, n // 2, n - 1):
        p, _ = junpack(js, jnp.asarray(rt.samples[i].numpy()))
        ref = np.asarray(jlin.jitter_cholesky(
            jmixed_gram(js, jnp.asarray(x), p), 1e-9))
        assert_close(chol[i], ref)


def test_capped_stash_flags_and_keeps_the_chain(problem, laplace_fit):
    x, y, js, ts, jkw, tkw = problem
    lpt = make_logpost(ts, t(x), t(y), t(0.05), **tkw)
    rounds_t = make_mh_rounds(ts, t(x), t(y), t(0.05), stash=True, **tkw)
    fit_t = laplace_from_numpy(laplace_fit.mode, laplace_fit.cov,
                               laplace_fit.logpost, device="cpu")
    kw = dict(laplace_fit=fit_t, speculative=4, mh_rounds=rounds_t,
              n_max=300, samp_size=30, batch_size=20, alpha_geweke=2.0,
              rounds_per_call=16, rounds_per_call_warm=16,
              stash_rows=len(y) + 2, stash_lanes=len(y))
    start = t(np.asarray(laplace_fit.mode))
    r_ok = metropolis(lpt, start, key_from_numpy(jax.random.PRNGKey(3), device="cpu"),
                      stash_cap=None, **kw)
    r_bad = metropolis(lpt, start, key_from_numpy(jax.random.PRNGKey(3), device="cpu"),
                       stash_cap=130, **kw)
    assert r_ok.n_recorded == r_bad.n_recorded == 300
    assert r_ok.factors_ok and not r_bad.factors_ok
    assert r_bad.factors.shape[0] == 130
    assert torch.equal(r_ok.samples, r_bad.samples)
    assert torch.equal(r_ok.factors[:100], r_bad.factors[:100])


def test_unported_samplers_raise(problem):
    """The samplers that raised before this slice now run as JAX routes
    them: K = 1 ignores mh_rounds (the K = 1 body), K = 4 without
    mh_rounds takes body_spec on the batched logpost; only the combination
    JAX refuses, speculative with record="all", still raises, as a
    ValueError in both packages."""
    x, y, js, ts, jkw, tkw = problem
    lpt = make_logpost(ts, t(x), t(y), t(0.05), **tkw)
    lpj = jlogpost(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(0.05),
                   **jkw)
    rounds_t = make_mh_rounds(ts, t(x), t(y), t(0.05), **tkw)
    key = jax.random.PRNGKey(0)
    for kw in (dict(speculative=0), dict(speculative=4)):
        got = metropolis(lpt, t(START), key_from_numpy(key, device="cpu"),
                         n_max=40, samp_size=20, mh_rounds=rounds_t
                         if kw["speculative"] == 0 else None, **kw)
        ref = jax.jit(lambda k: jmetropolis(
            lambda z: lpj(z), jnp.asarray(START), k, n_max=40,
            samp_size=20, **kw))(key)
        assert got.n_recorded == int(ref.n_recorded)
        assert got.n_proposals == int(ref.n_proposals)
        assert_close(got.samples[:got.n_recorded],
                     np.asarray(ref.samples)[:got.n_recorded], 1e-6)
    with pytest.raises(ValueError):
        metropolis(lpt, t(START), key_from_numpy(key, device="cpu"),
                   n_max=10, samp_size=5, speculative=4,
                   mh_rounds=rounds_t, record="all")
    with pytest.raises(ValueError):
        jmetropolis(lpj, jnp.asarray(START), key, n_max=10, samp_size=5,
                    speculative=4, record="all")
