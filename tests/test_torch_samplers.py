"""The port's one-round Metropolis drivers and its BFGS plug-in against
the JAX package, float64 on the CPU, with the same key:

* the K = 1 body (record "accepted" and "all"), `body_spec` (with
  `make_logpost_batch`, and on the batched `logpost`) and `body_mh`
  (`make_mh_round`), from the same Laplace fit;
* the chunked driver on a Matern mixture (the plain fallback of
  `make_mh_rounds`) against `body_spec` inside the port;
* `multistart_minimize` and `kriging_mle`.

Tolerances: chain counters equal and the recorded draws within 1e-8
(the log-posteriors agree to roundoff, so every accept/reject decision is
the same and the draws inherit only that roundoff); optima theta and
sigma^2 within 1e-8 relative (BFGS stops at gtol 1e-5: the returned point
moves with the roundoff of the gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.infer.laplace import laplace as jlaplace
from ccgp_tpu.infer.metropolis import metropolis as jmetro
from ccgp_tpu.infer.mle import kriging_mle as jkmle
from ccgp_tpu.infer.optim import multistart_minimize as jmulti
from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN
from ccgp_tpu.models import MixtureSpec as JSpec
from ccgp_tpu.models.likelihood import (
    make_logpost as jlogpost, make_logpost_batch as jbatch,
    make_mh_round as jround)
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.infer.metropolis import metropolis as tmetro
from ccgp_tpu_torch.infer.mle import kriging_mle as tkmle
from ccgp_tpu_torch.infer.optim import multistart_minimize as tmulti
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.convert import key_from_numpy, laplace_from_numpy
from ccgp_tpu_torch.models.likelihood import (
    make_logpost as tlogpost, make_logpost_batch as tbatch,
    make_mh_round as tround, make_mh_rounds as trounds)
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import chol_smallk, kernels as tkern, rng

RUN = dict(n_max=120, samp_size=40, batch_size=20)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def problem():
    r = np.random.default_rng(11)
    x = r.uniform(size=(12, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    js = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
    ts = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
    jpri = dict(theta1_prior=JLN(0.0, 1.0), theta2_prior=JIG(3, 4))
    tpri = dict(theta1_prior=LogNormal(0.0, 1.0),
                theta2_prior=InverseGamma(3, 4))
    args_j = (js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(0.3))
    args_t = (ts, t(x), t(y), t(0.3))
    lj = jlogpost(*args_j, jitter=1e-8, **jpri)
    fit = jax.jit(lambda s: jlaplace(lambda z: lj(z).val, s))(
        jnp.asarray([1.0, 2.0, 0.0]))
    return dict(args_j=args_j, args_t=args_t, jpri=jpri, tpri=tpri, lj=lj,
                lt=tlogpost(*args_t, jitter=1e-8, **tpri), fit=fit,
                tfit=laplace_from_numpy(fit.mode, fit.cov, fit.logpost,
                                        device="cpu"))


def _compare(jres, tres):
    assert tres.n_recorded == int(jres.n_recorded)
    assert tres.n_proposals == int(jres.n_proposals)
    assert tres.n_accepted == int(jres.n_accepted)
    assert tres.n_rounds == int(jres.n_rounds)
    assert tres.converged == bool(jres.converged)
    k = tres.n_recorded
    assert k > RUN["samp_size"]
    for f in ("samples", "betas", "logposts"):
        got = getattr(tres, f).numpy()[:k]
        ref = np.asarray(getattr(jres, f))[:k]
        assert float(np.max(np.abs(got - ref))) <= 1e-8, f
    assert abs(tres.pvalue - float(jres.pvalue)) <= 1e-8


@pytest.mark.parametrize("route", ["k1_accepted", "k1_all", "spec_batch",
                                   "spec_logpost", "mh_round"])
def test_one_round_drivers_match_jax(problem, route):
    p = problem
    kw_j, kw_t = {}, {}
    record = "all" if route == "k1_all" else "accepted"
    K = 0 if route.startswith("k1") else 4
    if route == "spec_batch":
        kw_j["logpost_batch"] = jbatch(*p["args_j"], jitter=1e-8, **p["jpri"])
        kw_t["logpost_batch"] = tbatch(*p["args_t"], jitter=1e-8, **p["tpri"])
    if route == "mh_round":
        kw_j["mh_round"] = jround(*p["args_j"], jitter=1e-8, **p["jpri"])
        kw_t["mh_round"] = tround(*p["args_t"], jitter=1e-8, **p["tpri"])
    key = jax.random.PRNGKey(5)
    jres = jax.jit(lambda k: jmetro(p["lj"], p["fit"].mode, k, record=record,
                                    laplace_fit=p["fit"], speculative=K,
                                    **RUN, **kw_j))(key)
    launches = (chol_smallk.fused_mix_quadratics_smallk.launches,
                chol_smallk.fused_mix_mh_round.launches)
    tres = tmetro(p["lt"], p["tfit"].mode, key_from_numpy(key, device="cpu"),
                  record=record, laplace_fit=p["tfit"], speculative=K,
                  **RUN, **kw_t)
    _compare(jres, tres)
    # the CPU takes the kernels' plain twins: no launch
    assert launches == (chol_smallk.fused_mix_quadratics_smallk.launches,
                        chol_smallk.fused_mix_mh_round.launches)


def test_speculative_needs_accepted_only(problem):
    with pytest.raises(ValueError):
        tmetro(problem["lt"], problem["tfit"].mode,
               rng.PRNGKey(0, device="cpu"), record="all", speculative=4,
               laplace_fit=problem["tfit"], **RUN)


def test_chunked_matern_fallback_equals_body_spec():
    """make_mh_rounds on a Matern mixture runs the plain loop of
    batched log-posteriors; the chunked driver over it records the chain
    body_spec records."""
    r = np.random.default_rng(4)
    x = r.uniform(size=(8, 1))
    y = np.sin(10 * x[:, 0])
    spec = TSpec(tkern.matern_family(5.0), tkern.spline_family(), dim=1)
    pri = dict(theta1_prior=InverseGamma(3, 2),
               theta2_prior=InverseGamma(5, 16))
    args = (spec, t(x), t(y), t(0.2))
    lp = tlogpost(*args, **pri)
    fit = laplace_from_numpy([0.0, 1.0, 0.0], np.diag([0.3, 0.3, 0.5]), 0.0,
                             device="cpu")
    key = rng.PRNGKey(2, device="cpu")
    run = dict(n_max=80, samp_size=30, batch_size=10, laplace_fit=fit,
               speculative=4)
    a = tmetro(lp, fit.mode, key, mh_rounds=trounds(*args, **pri), **run)
    b = tmetro(lp, fit.mode, key, logpost_batch=tbatch(*args, **pri), **run)
    for f in ("n_recorded", "n_proposals", "n_rounds", "converged"):
        assert getattr(a, f) == getattr(b, f), f
    k = a.n_recorded
    assert torch.equal(a.samples[:k], b.samples[:k])
    with pytest.raises(ValueError):
        trounds(*args, stash=True, **pri)(fit.mode, lp(fit.mode).val, 0.0,
                                           torch.zeros((8, 3),
                                                       dtype=torch.float64),
                                           torch.zeros((2, 4),
                                                       dtype=torch.float64))


def _bowl(lib):
    def f(z):
        return (z[0] - 0.3) ** 2 + 10.0 * (z[1] - z[0] ** 2) ** 2
    return f


def test_multistart_minimize_matches_jax():
    starts = np.array([[-1.5, 1.0], [0.5, -0.5], [1.8, 1.8], [0.0, 0.0]])
    lo, hi = np.array([-2.0, -2.0]), np.array([2.0, 2.0])
    rj = jmulti(_bowl("jax"), jnp.asarray(starts), jnp.asarray(lo),
                jnp.asarray(hi))
    rt = tmulti(_bowl("torch"), t(starts), t(lo), t(hi))
    for f in ("x", "fun", "xs", "funs"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    # unbounded: the starts are the unconstrained points
    rj = jmulti(_bowl("jax"), jnp.asarray(starts))
    rt = tmulti(_bowl("torch"), t(starts))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


@pytest.mark.parametrize("case", ["se_2d", "matern_1d", "se_2d_ard"])
def test_kriging_mle_matches_jax(case):
    if case == "matern_1d":
        x = np.random.default_rng(7).uniform(size=(8, 1))
        y = 0.5 * np.sin(10 * x[:, 0]) + 0.5 * np.cos(15 * x[:, 0])
        jf, tf = jkern.matern_family(5.0), tkern.matern_family(5.0)
    else:
        # a rough response: the optimum's Gram is well conditioned. On a
        # smooth one (optimal rate ~2, condition ~1e10 at jitter 1e-10)
        # BFGS's stopping point moves ~1e-8 with the gradients' roundoff.
        x = np.random.default_rng(1).uniform(size=(14, 2))
        y = np.sin(9 * x[:, 0]) * np.cos(7 * x[:, 1])
        jf, tf = jkern.sqexp_family(), tkern.sqexp_family()
    ard = case.endswith("ard")
    key = jax.random.PRNGKey(9)
    mj = jax.jit(lambda a, b, k: jkmle(jf, a, b, k, ard=ard))(
        jnp.asarray(x), jnp.asarray(y), key)
    mt = tkmle(tf, t(x), t(y), key_from_numpy(key, device="cpu"), ard=ard)
    for f in ("theta", "sigma2", "beta", "nll"):
        ref = np.asarray(getattr(mj, f))
        got = getattr(mt, f).numpy()
        assert got.shape == ref.shape, f
        assert float(np.max(np.abs(got - ref) / np.abs(ref))) <= 1e-8, f
