"""The port's last options and names against the JAX package, float64 on
the CPU: `run_study(run_single=, cgp_candidates=, on_unconverged=)`, the
studies' `design=`, `mlegp_fit`'s search options, `cgp_fit`'s box,
`num_starts` and `jackknife=False`, `cgp_predict(alpha_level=)`,
`predictive_moments(solve_mode=)`, JAX's one-design `sharded_design_sweep`,
`multi_chain_metropolis` over distinct devices, the draws' 64-bit
counter, `split_chain_supported` and `positive_to_log`.

Tolerances: deterministic float64 math at the same inputs 1e-10 relative
to max(1, |value|) (`_bounds`, `cgp_predict` at a carried fit, the
`inv_matmul` moments); fits from scratch carry their optimizer's stopping
point, as `tests/test_torch_baselines.py` states: `cgp_fit` 1e-8,
`mlegp_fit` theta 1e-6 and sigma^2 / beta 1e-7; studies: chain counters
equal, draws, predictions and summaries within 1e-8 where sigma^2 is
given and 1e-7 where a BFGS fit makes it (`tests/test_torch_study.py`);
keys, designs and random bits equal; the two solve modes within JAX's own
`tests/test_predict.py` tolerances (1e-8 on means, 1e-12 on variances).
"""
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu import parallel as jpar
from ccgp_tpu.design.lhs import maximin_lhs as jmaximin
from ccgp_tpu.experiments import common as jcommon
from ccgp_tpu.experiments import sim_1d_two_families as jsim_tf
from ccgp_tpu.experiments import sim_2d_aniso as jsim_aniso
from ccgp_tpu.infer.mle import mlegp_fit as jmlegp_fit
from ccgp_tpu.models import InverseGamma as JIG
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import composite_gp as jcgp
from ccgp_tpu.models import make_logpost as jlogpost
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu.ops import pallas_rng as jpallas_rng
from ccgp_tpu.predict import factors as jfactors
from ccgp_tpu.predict import posterior as jposterior
from ccgp_tpu.utils import transforms as jtransforms
from ccgp_tpu_torch import parallel as tpar
from ccgp_tpu_torch.design.lhs import maximin_lhs, random_lhs
from ccgp_tpu_torch.experiments import common as tcommon
from ccgp_tpu_torch.experiments import (
    sim_1d, sim_1d_two_families, sim_2d_aniso, sim_2d_iso)
from ccgp_tpu_torch.infer.mle import mlegp_fit
from ccgp_tpu_torch.models import composite_gp as tcgp
from ccgp_tpu_torch.models.combination import MixParams
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.convert import cgp_from_numpy
from ccgp_tpu_torch.models.likelihood import make_logpost, make_logpost_lanes
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels as tkern, rng
from ccgp_tpu_torch.predict.factors import FactorCache
from ccgp_tpu_torch.predict.posterior import predictive_moments
from ccgp_tpu_torch.utils import transforms as ttransforms

FAST = dict(n_max=1200, samp_size=300, net_samp_size=200)   # the CLI's --fast
TOL = 1e-8
PLUGIN_TOL = 1e-7   # a BFGS plug-in (module docstring)


def close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def compare(jres, tres, tol=TOL):
    """Equal chain counters; draws, predictions and summaries within tol."""
    jm, tm = jres.fit.mcmc, tres.fit.mcmc
    assert tm.n_recorded == int(jm.n_recorded)
    assert tm.n_proposals == int(jm.n_proposals)
    assert tm.converged == bool(jm.converged)
    assert tres.fit.chain_ok == bool(jres.fit.chain_ok)
    close(tres.fit.sigma2, jres.fit.sigma2, tol)
    close(tres.fit.zs, jres.fit.zs, tol)
    assert set(tres.predictions) == set(jres.predictions)
    for name, jp in jres.predictions.items():
        tp = tres.predictions[name]
        for f in ("mean", "lower", "upper", "quant"):
            assert (getattr(tp, f) is None) == (getattr(jp, f) is None)
            if getattr(jp, f) is not None:
                close(getattr(tp, f), getattr(jp, f), tol)
    js, ts = jres.summary, tres.summary
    for name in js.rmspe:
        close(ts.rmspe[name], js.rmspe[name], tol)
        close(ts.coverage[name], js.coverage[name], tol)
    close(ts.average_quantile, js.average_quantile, tol)


def equal_results(a, b):
    """Two StudyResults of the port, bit for bit."""
    assert a.fit.mcmc.n_recorded == b.fit.mcmc.n_recorded
    assert a.fit.mcmc.n_proposals == b.fit.mcmc.n_proposals
    assert torch.equal(a.fit.zs, b.fit.zs)
    assert torch.equal(a.fit.sigma2, b.fit.sigma2)
    assert set(a.predictions) == set(b.predictions)
    for name, p in a.predictions.items():
        for f in ("mean", "lower", "upper", "quant"):
            if getattr(p, f) is not None:
                np.testing.assert_array_equal(getattr(p, f),
                                              getattr(b.predictions[name], f))
    assert a.summary == b.summary
    np.testing.assert_array_equal(a.y_true, b.y_true)


def small_problem():
    r = np.random.default_rng(5)
    x = r.uniform(size=(10, 2))
    f = lambda v: np.sin(4 * v[:, 0]) + v[:, 1] ** 2  # noqa: E731
    xn = r.uniform(size=(16, 2))
    return x, f(x), xn, f(xn)


# ---------------------------------------------------------------------------
# run_study's options
# ---------------------------------------------------------------------------

OPTION_CASES = {
    # sigma^2 given and no single GP: the mlegp fit must not run
    "mlegp-sigma2-no-single": dict(
        single_variant="mlegp", sigma2=0.8, run_single=False,
        cgp_candidates=105, on_unconverged="raise"),
    # no sigma^2: the mlegp fit runs for the plug-in alone
    "mlegp-no-single": dict(single_variant="mlegp", run_single=False,
                            run_cgp=False, on_unconverged="ignore"),
    "reference-no-single": dict(single_variant="reference", sigma2=0.5,
                                run_single=False, cgp_candidates=55,
                                on_unconverged="warn"),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_run_study_options_match_jax(case, monkeypatch):
    opts = OPTION_CASES[case]
    kw = dict(start=(1.0, 1.0, 0.0), **FAST)
    x, y, xn, yt = small_problem()
    calls = []
    for name in ("mlegp_fit", "kriging_mle", "cgp_fit"):
        fn = getattr(tcommon, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, k))
            return _fn(*a, **k)
        monkeypatch.setattr(tcommon, name, spy)
    tres = tcommon.run_study(
        TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2), x, y, xn,
        yt, rng.PRNGKey(2, device="cpu"), MCMCConfig(**kw),
        theta1_prior=InverseGamma(3, 2), theta2_prior=InverseGamma(5, 16),
        device="cpu", **opts)
    jres = jcommon.run_study(
        JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(xn), yt,
        jax.random.PRNGKey(2), JCfg(**kw), theta1_prior=JIG(3, 2),
        theta2_prior=JIG(5, 16), **opts)
    compare(jres, tres, TOL if "sigma2" in opts else PLUGIN_TOL)
    assert "single" not in tres.predictions
    names = [c[0] for c in calls]
    assert "kriging_mle" not in names
    assert ("mlegp_fit" in names) == ("sigma2" not in opts)
    cgp = [k for n, k in calls if n == "cgp_fit"]
    if opts.get("run_cgp", True):
        assert cgp == [dict(n_candidates=opts["cgp_candidates"])]
    else:
        assert not cgp


def _unhealthy_problem():
    """tests/test_experiments.py's unconverged study: a 40-proposal cap
    that cannot fill a 300-draw window."""
    r = np.random.default_rng(3)
    x = r.uniform(size=(10, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    xn = r.uniform(size=(5, 2))
    yt = np.sin(5 * xn[:, 0]) + np.cos(3 * xn[:, 1])
    short = dict(n_max=400, samp_size=300, net_samp_size=200,
                 max_proposals=40)
    return x, y, xn, yt, short


def _run_both(on_unconverged):
    x, y, xn, yt, short = _unhealthy_problem()
    common = dict(jitter=1e-8, run_cgp=False, run_single=False,
                  on_unconverged=on_unconverged)

    def port():
        return tcommon.run_study(
            TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2), x, y,
            xn, yt, rng.PRNGKey(0, device="cpu"), MCMCConfig(**short),
            theta1_prior=InverseGamma(3, 2),
            theta2_prior=InverseGamma(5, 16), device="cpu", **common)

    def jax_():
        return jcommon.run_study(
            JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(xn), yt,
            jax.random.PRNGKey(0), JCfg(**short), theta1_prior=JIG(3, 2),
            theta2_prior=JIG(5, 16), **common)
    return port, jax_


def test_on_unconverged_matches_jax():
    """JAX's own cases (`tests/test_experiments.py:95-113`) in both
    packages: "warn" warns, "raise" raises, with the same message;
    "ignore" returns without a warning."""
    port, jax_ = _run_both("warn")
    with pytest.warns(RuntimeWarning, match="n_recorded") as tw:
        tres = port()
    with pytest.warns(RuntimeWarning, match="n_recorded") as jw:
        jres = jax_()
    assert not tres.fit.chain_ok and not bool(jres.fit.chain_ok)
    assert tres.fit.mcmc.n_recorded < 300
    compare(jres, tres)
    assert str(tw[0].message) == str(jw[0].message)

    port, jax_ = _run_both("raise")
    with pytest.raises(RuntimeError, match="unhealthy") as te:
        port()
    with pytest.raises(RuntimeError, match="unhealthy") as je:
        jax_()
    assert str(te.value) == str(je.value) == str(tw[0].message)

    port, _ = _run_both("ignore")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = port()
    assert not res.fit.chain_ok


def test_bad_on_unconverged_raises_before_anything_runs(monkeypatch):
    monkeypatch.setattr(tcommon, "fit_combined_gp", None)
    monkeypatch.setattr(tcommon, "mlegp_fit", None)
    x, y, xn, yt, short = _unhealthy_problem()
    for pkg_call in (
            lambda: tcommon.run_study(
                TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2), x,
                y, xn, yt, rng.PRNGKey(0, device="cpu"), MCMCConfig(**short),
                None, None, single_variant="mlegp", on_unconverged="loud",
                device="cpu"),
            lambda: jcommon.run_study(
                JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
                jnp.asarray(x), jnp.asarray(y), jnp.asarray(xn), yt,
                jax.random.PRNGKey(0), JCfg(**short), None, None,
                on_unconverged="loud")):
        with pytest.raises(ValueError, match="loud"):
            pkg_call()


# ---------------------------------------------------------------------------
# design= in the studies
# ---------------------------------------------------------------------------

ONE_D = MCMCConfig(start=(0.0, 1.5, 0.0), n_max=240, samp_size=80,
                   net_samp_size=60)
ISO = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=240, samp_size=80,
                 net_samp_size=60)
ANISO = MCMCConfig(start=(1.0, 1.0, 0.0, 0.0), n_max=240, samp_size=80,
                   net_samp_size=60)
STUDIES = {
    "sim_1d": (sim_1d, dict(mcmc=ONE_D, n_new=12), 1),
    "sim_1d_two_families": (sim_1d_two_families, dict(mcmc=ONE_D, n_new=12),
                            1),
    "sim_2d_iso": (sim_2d_iso, dict(mcmc=ISO, n_new_axis=5), 2),
    "sim_2d_aniso": (sim_2d_aniso, dict(mcmc=ANISO, n_new_axis=5), 2),
}


@pytest.mark.parametrize("name", list(STUDIES))
def test_the_default_design_given_is_the_default_study(name):
    """The key is split whether or not a design is given: run() and
    run(design=<the design run() draws>) are the same study, bit for bit;
    the design may come as numpy, as JAX's does (1-D flat, reshaped to
    (n_train, 1))."""
    mod, over, d = STUDIES[name]
    cfg = mod.Config(**over)
    key = rng.PRNGKey(4, device="cpu")
    k_d, _ = rng.split(key)
    design = (random_lhs(k_d, cfg.n_train, 1, torch.float64) if d == 1 else
              maximin_lhs(k_d, cfg.n_train, 2, dtype=torch.float64))
    given = design.numpy().reshape(-1) if d == 1 else design.numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = mod.run(cfg, key=key, device="cpu")
        got = mod.run(cfg, key=key, design=given, device="cpu")
    equal_results(got, ref)


def test_sim_2d_aniso_on_a_given_design_matches_jax():
    d = np.random.default_rng(11).uniform(size=(14, 2))
    kw = dict(start=(1.0, 1.0, 0.0, 0.0), n_max=240, samp_size=80,
              net_samp_size=60)
    jres = jsim_aniso.run(jsim_aniso.Config(mcmc=JCfg(**kw), n_new_axis=5),
                          key=jax.random.PRNGKey(3), design=d)
    tres = sim_2d_aniso.run(
        sim_2d_aniso.Config(mcmc=MCMCConfig(**kw), n_new_axis=5),
        key=rng.PRNGKey(3, device="cpu"), design=d, device="cpu")
    compare(jres, tres, PLUGIN_TOL)


def test_sim_1d_two_families_on_a_given_design_matches_jax():
    """A flat 1-D design, and `compat_unnormalized_cross=True`, which JAX's
    `run` does not read: both packages run the normalized cross."""
    d = np.random.default_rng(12).uniform(size=8)
    kw = dict(start=(0.0, 1.5, 0.0), n_max=240, samp_size=80,
              net_samp_size=60)
    assert not sim_1d_two_families.Config().compat_unnormalized_cross
    jres = jsim_tf.run(jsim_tf.Config(mcmc=JCfg(**kw), n_new=12,
                                      compat_unnormalized_cross=True),
                       key=jax.random.PRNGKey(3), design=d)
    tres = sim_1d_two_families.run(
        sim_1d_two_families.Config(mcmc=MCMCConfig(**kw), n_new=12,
                                   compat_unnormalized_cross=True),
        key=rng.PRNGKey(3, device="cpu"), design=d, device="cpu")
    compare(jres, tres, PLUGIN_TOL)


# ---------------------------------------------------------------------------
# the baselines' search options
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    """sim_2d_iso's design for PRNGKey(0), function 2, and a 7 x 7
    lattice (`tests/test_torch_baselines.py`'s data)."""
    from ccgp_tpu.eval.functions import test_function_2d as jf2d

    x = np.asarray(jmaximin(jax.random.PRNGKey(0), 14, 2))
    y = np.asarray(jf2d(jnp.asarray(x), 2))
    u = np.linspace(0, 1, 7)
    return x, y, np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)


MLEGP_CASES = [
    dict(n_random=4, maxiter=100, log_theta_low=-8.0, log_theta_high=8.0),
    dict(n_random=0),
    dict(n_random=5, key=None),
]


@pytest.mark.parametrize("opts", MLEGP_CASES)
def test_mlegp_fit_options_match_jax(data, opts):
    x, y, _ = data
    opts = dict(opts)
    key = opts.pop("key", 3)
    ref = jmlegp_fit(jkern.sqexp_family(), jnp.asarray(x), jnp.asarray(y),
                     None if key is None else jax.random.PRNGKey(key),
                     jitter=0.0, **opts)
    got = mlegp_fit(tkern.sqexp_family(), torch.tensor(x), torch.tensor(y),
                    None if key is None else rng.PRNGKey(key, device="cpu"),
                    jitter=0.0, **opts)
    close(got.theta, ref.theta, 1e-6)
    close(got.nll, ref.nll, 1e-10)
    close(got.sigma2, ref.sigma2, 1e-7)
    close(got.beta, ref.beta, 1e-7)
    lo, hi = opts.get("log_theta_low", -14.0), opts.get("log_theta_high",
                                                         14.0)
    assert bool(torch.all((torch.log(got.theta) >= lo)
                          & (torch.log(got.theta) <= hi)))


BOUNDS_CASES = {
    "defaults": dict(),
    "theta_l-kappa_u-nugget_l": dict(nugget_l=0.01, theta_l=1e-3,
                                     kappa_u=50.0),
    "alpha_l": dict(alpha_l=2.0),
    "alpha_l-array": dict(alpha_l=np.array([1.5, 2.5]), kappa_u=30.0),
}


@pytest.mark.parametrize("case", list(BOUNDS_CASES))
def test_cgp_bounds_match_jax(data, case):
    x, _, _ = data
    o = BOUNDS_CASES[case]
    args = (o.get("nugget_l", 0.001), o.get("theta_l"), o.get("alpha_l"),
            o.get("kappa_u"))
    xs_j, _ = jcgp._standardize(jnp.asarray(x))
    xs_t, _ = tcgp._standardize(torch.tensor(x))
    lo_j, hi_j = jcgp._bounds(xs_j, 2, *args, jnp.float64)
    lo_t, hi_t = tcgp._bounds(xs_t, 2, *args, torch.float64)
    close(lo_t, lo_j, 1e-10)
    close(hi_t, hi_j, 1e-10)


def test_cgp_fit_options_match_jax(data):
    """jackknife=False leaves rmscv NaN; num_starts, nugget_l, theta_l,
    alpha_l and kappa_u set the search; alpha_level is accepted and, as
    in JAX, does not move the +/-1.96 sigma interval."""
    x, y, x_new = data
    opts = dict(nugget_l=0.01, num_starts=3, theta_l=1e-3, alpha_l=5.0,
                kappa_u=50.0, n_candidates=105, jackknife=False)
    jfit = jcgp.cgp_fit(jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(3), **opts)
    fit = tcgp.cgp_fit(torch.tensor(x), torch.tensor(y),
                       rng.PRNGKey(3, device="cpu"), **opts)
    assert bool(torch.isnan(fit.rmscv)) and bool(jnp.isnan(jfit.rmscv))
    assert fit.rmscv.dtype == torch.float64
    for f in jcgp.CGPFit._fields:
        if f != "rmscv":
            close(getattr(fit, f), getattr(jfit, f), 1e-8)
    lo, hi = tcgp._bounds(tcgp._standardize(torch.tensor(x))[0], 2, 0.01,
                          1e-3, 5.0, 50.0)
    w = torch.cat([fit.lam[None], fit.theta * tcgp._standardize(
        torch.tensor(x))[1] ** 2])
    assert bool(torch.all((w >= lo[:3] - 1e-12) & (w <= hi[:3] + 1e-12)))
    jpred = jcgp.cgp_predict(jfit, jnp.asarray(x_new), alpha_level=0.1)
    pred = tcgp.cgp_predict(fit, torch.tensor(x_new), alpha_level=0.1)
    for f in jcgp.CGPPrediction._fields:
        close(getattr(pred, f), getattr(jpred, f), 1e-8)
    same = tcgp.cgp_predict(fit, torch.tensor(x_new))
    for a, b in zip(pred, same):
        assert torch.equal(a, b)
    carried = cgp_from_numpy(**{f: np.asarray(getattr(jfit, f))
                                for f in jcgp.CGPFit._fields}, device="cpu")
    pred = tcgp.cgp_predict(carried, torch.tensor(x_new), alpha_level=0.1)
    for f in jcgp.CGPPrediction._fields:
        close(getattr(pred, f), getattr(jpred, f), 1e-10)


def test_cgp_fit_defaults_are_the_named_ones(data):
    x, y, _ = data
    args = (torch.tensor(x), torch.tensor(y), rng.PRNGKey(1, device="cpu"))
    a = tcgp.cgp_fit(*args, n_candidates=55)
    b = tcgp.cgp_fit(*args, nugget_l=0.001, num_starts=5, theta_l=None,
                     alpha_l=None, kappa_u=None, n_candidates=55,
                     jackknife=True)
    for f, g in zip(a, b):
        assert torch.equal(f, g)
    assert bool(torch.isfinite(a.rmscv))


# ---------------------------------------------------------------------------
# predictive_moments(solve_mode=)
# ---------------------------------------------------------------------------

def _moments_problem(jitter):
    """JAX's `tests/test_predict.py::test_moments_solve_modes_agree`
    problem at `jitter`, the JAX factor cache carried to the port."""
    r = np.random.default_rng(0)
    x = r.uniform(size=(18, 2))
    y = r.normal(size=18)
    xt = r.uniform(size=(11, 2))
    zs = 0.3 * r.normal(size=(9, 3))
    betas = 0.1 * r.normal(size=9)
    jspec = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)
    jcache = jfactors.build_factors(jspec, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(zs), jnp.asarray(betas),
                                    jitter=jitter)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    cache = FactorCache(chol=t(jcache.chol), a=t(jcache.a), u=t(jcache.u),
                        beta=t(jcache.beta),
                        params=MixParams(*(t(v) for v in jcache.params)))
    tspec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)
    return (jspec, jcache, jnp.asarray(x), jnp.asarray(xt)), (
        tspec, cache, torch.tensor(x), torch.tensor(xt))


# jitter -> (means, variances) tolerance against JAX's same mode. At 1e-4
# the deterministic-math tier, 1e-10 relative; JAX's own problem (1e-6) is
# near-singular enough that its two modes part by 1.2e-9 on the means, and
# the packages' same mode by 1.7e-10 (trsm) and 4.3e-10 (inv_matmul) in
# float64 on the CPU: there, JAX's own test's bounds, 1e-8 and 1e-12
# absolute.
MOMENTS_TOL = {1e-4: (1e-10, 1e-10), 1e-6: (1e-8, 1e-12)}


@pytest.mark.parametrize("jitter", list(MOMENTS_TOL))
def test_predictive_moments_solve_modes_match_jax(jitter):
    (jspec, jcache, jx, jxt), (tspec, cache, x, xt) = _moments_problem(
        jitter)
    jm = {mode: jposterior.predictive_moments(jspec, jcache, jx, jxt, 0.8,
                                              solve_mode=mode)
          for mode in ("trsm", "inv_matmul", "other")}
    tm = {mode: predictive_moments(tspec, cache, x, xt, 0.8,
                                   solve_mode=mode)
          for mode in (None, "trsm", "inv_matmul")}
    tol_m, tol_v = MOMENTS_TOL[jitter]
    for mode in ("trsm", "inv_matmul"):
        close(tm[mode][0], jm[mode][0], tol_m)
        # a variance near 0 is the cancellation 1 - r'R^-1 r: relative to
        # max(|v|, sigma^2)
        err = (np.abs(tm[mode][1].numpy() - np.asarray(jm[mode][1]))
               / np.maximum(0.8, np.abs(np.asarray(jm[mode][1]))))
        assert float(err.max()) <= tol_v
    # None is trsm; any other value JAX takes as trsm, the port refuses
    for a, b in zip(tm[None], tm["trsm"]):
        assert torch.equal(a, b)
    for a, b in zip(jm["other"], jm["trsm"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="other"):
        predictive_moments(tspec, cache, x, xt, 0.8, solve_mode="other")
    # the two modes within JAX's own tolerances
    np.testing.assert_allclose(tm["trsm"][0], tm["inv_matmul"][0], atol=1e-8)
    np.testing.assert_allclose(tm["trsm"][1], tm["inv_matmul"][1],
                               atol=1e-12)


# ---------------------------------------------------------------------------
# parallel/: JAX's one-design sweep, chains over distinct devices
# ---------------------------------------------------------------------------

def _tspec():
    return TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2)


def _jspec():
    return JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)


PRIORS = dict(theta1_prior=InverseGamma(3, 2),
              theta2_prior=InverseGamma(5, 16))


def _jfit_one(design, key):
    lp = jlogpost(_jspec(), design, jnp.sin(5.0 * design[:, 0]), 0.5,
                  theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16),
                  jitter=1e-5)
    return lp(0.1 * jax.random.normal(key, (3,), design.dtype)).val


def _tfit_one(design, key):
    lp = make_logpost(_tspec(), design, torch.sin(5.0 * design[:, 0]), 0.5,
                      jitter=1e-5, **PRIORS)
    return lp(0.1 * rng.normal(key, (3,), design.dtype)).val


def test_sharded_design_sweep_takes_jax_one_design_fit():
    designs = np.random.default_rng(0).uniform(size=(10, 9, 2))
    ref = jpar.sharded_design_sweep(
        _jfit_one, jnp.asarray(designs),
        jax.random.split(jax.random.PRNGKey(0), 10), jpar.make_mesh(1))
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 10)
    td = torch.tensor(designs)
    outs = [tpar.sharded_design_sweep(_tfit_one, td, keys,
                                      tpar.make_mesh(devices=devs))
            for devs in (["cpu"], ["cpu"] * 8, ["cpu", "cpu:0"])]
    assert outs[0].shape == (10,)
    close(outs[0], ref, 1e-10)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])

    # the batched route, one call per shard: the lanes log-posterior
    def batched(ds, ks):
        lp = make_logpost_lanes(_tspec(), ds, torch.sin(5.0 * ds[..., 0]),
                                0.5, jitter=1e-5, **PRIORS)
        return lp(0.1 * rng.normal(ks, (3,), ds.dtype)).val

    close(tpar.sharded_design_sweep(batched, td, keys,
                                    tpar.make_mesh(devices=["cpu"] * 8),
                                    batched=True), ref, 1e-10)

    # tuples of tensors and arrays are stacked field by field
    def pair(d, k):
        v = _tfit_one(d, k)
        return v, v.numpy() * 2

    v, w = tpar.sharded_design_sweep(pair, td, keys,
                                     tpar.make_mesh(devices=["cpu"] * 4))
    assert torch.equal(v, outs[0]) and np.array_equal(w, 2 * outs[0].numpy())


def _chains_problem():
    r = np.random.default_rng(0)
    x, y = r.uniform(size=(8, 2)), r.normal(size=8)
    lp = make_logpost(_tspec(), torch.tensor(x), torch.tensor(y), 1.0,
                      **PRIORS)
    starts = torch.tensor(np.tile([0.0, 1.0, 0.0], (6, 1)))
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 6)
    return lp, starts, keys, dict(n_max=200, samp_size=100, alpha_geweke=0.9)


def _equal_chains(a, b):
    for f in ("samples", "betas", "logposts"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("n_recorded", "n_proposals", "n_accepted", "pvalue",
              "converged", "n_rounds"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f, g in zip(a.laplace, b.laplace):
        assert torch.equal(f, g)


def test_multi_chain_metropolis_on_distinct_devices():
    """A mesh of two distinct devices ("cpu" and "cpu:0", which PyTorch
    names apart) runs a shard on each, a host thread each, with
    `logpost.to(device)`: each shard's chains equal the same chains on its
    device alone, bit for bit."""
    lp, starts, keys, run = _chains_problem()
    two = tpar.multi_chain_metropolis(
        lp, starts, keys, tpar.make_mesh(devices=["cpu", "cpu:0"]), **run)
    assert two.samples.shape == (6, 200, 3)
    one = tpar.make_mesh(devices=["cpu"])
    for sl in (slice(0, 3), slice(3, 6)):
        alone = tpar.multi_chain_metropolis(lp, starts[sl], keys[sl], one,
                                            **run)
        _equal_chains(type(two)(*(f[sl] if not isinstance(f, tuple) else
                                  type(f)(*(g[sl] for g in f))
                                  for f in two)), alone)
    # a closure without .to cannot be moved to another device
    with pytest.raises(TypeError, match=r"\.to\(device\)"):
        tpar.multi_chain_metropolis(
            lambda z: lp(z), starts, keys,
            tpar.make_mesh(devices=["cpu", "cpu:0"]), **run)


def test_make_logpost_to_a_device_is_the_same_log_posterior():
    lp, starts, _, _ = _chains_problem()
    moved = lp.to("cpu:0")
    for a, b in zip(lp(starts)[:2], moved(starts)[:2]):
        assert torch.equal(a, b)


def test_distinct_devices_run_at_once():
    """`_on_devices` gives each distinct device a host thread: two shards
    that wait for each other both finish; a repeated device runs its
    shards in order on the caller's thread."""
    from ccgp_tpu_torch.parallel.sharded import _on_devices

    barrier = threading.Barrier(2, timeout=30)

    def meet(dev, a):
        barrier.wait()
        return a * 2

    out = _on_devices(meet, tpar.make_mesh(devices=["cpu", "cpu:0"]),
                      torch.arange(4.0))
    assert [o.tolist() for o in out] == [[0.0, 2.0], [4.0, 6.0]]
    seen = []
    _on_devices(lambda dev, a: seen.append(threading.get_ident()),
                tpar.make_mesh(devices=["cpu"] * 3), torch.arange(3.0))
    assert seen == [threading.get_ident()] * 3

    def fail(dev, a):
        if str(dev) == "cpu:0":
            raise ArithmeticError("shard 1")
        return a

    with pytest.raises(ArithmeticError, match="shard 1"):
        _on_devices(fail, tpar.make_mesh(devices=["cpu", "cpu:0"]),
                    torch.arange(4.0))


# ---------------------------------------------------------------------------
# the random stream: 2^24 draws a round, the 64-bit counter, the names
# ---------------------------------------------------------------------------

def test_chunk_draws_plain_at_2_24_draws_per_round_matches_jax():
    """K dim = 2^24 (rr = 1, f32), where the kernel indexes a segment in 64
    bits: the wrapper no longer refuses it, and the plain version's keys,
    random bits and uniforms equal jax.random's, its normals and
    log-uniforms within `tests/test_torch_chunk_draws.py`'s tolerances,
    on a slice of the rows."""
    K = dim = 1 << 12
    key = rng.PRNGKey(5, device="cpu")
    new_key, eps, log_u = rng.chunk_draws(key, 1, K, dim, torch.float32)
    assert eps.shape == (1, K, dim) and log_u.shape == (1, K)
    jkey, jk1, jk2 = jax.random.split(jax.random.PRNGKey(5), 3)
    np.testing.assert_array_equal(new_key.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    _, k1s, k2s = rng.threefry_split_chain_plain(key, 1)
    np.testing.assert_array_equal(k1s[0].numpy(),
                                  np.asarray(jk1).astype(np.int64))
    rows = np.r_[0:3, 2047, K - 2:K]
    jbits = np.asarray(jax.random.bits(jk1, (K, dim), jnp.uint32))[rows]
    bits = rng.random_bits(k1s[0], 32, (K, dim))[rows]
    np.testing.assert_array_equal(bits.numpy(), jbits.astype(np.int64))
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = rng.uniform(k1s[0], (K, dim), torch.float32, lo, 1.0)[rows]
    ju = np.asarray(jax.random.uniform(jk1, (K, dim), jnp.float32, lo,
                                       1.0))[rows]
    np.testing.assert_array_equal(u.numpy(), ju)
    jeps = np.asarray(jax.random.normal(jk1, (K, dim), jnp.float32))[rows]
    got = eps[0, rows]
    far = np.abs(got.numpy() - jeps) > 1e-6
    exact = np.sqrt(2.0) * torch.special.erfinv(u.double()).numpy()
    ulp = np.spacing(np.abs(got.numpy())).astype(np.float64)
    assert (np.abs(got.numpy() - exact)[far] <= 2 * ulp[far]).all()
    jlog_u = np.log(np.asarray(jax.random.uniform(jk2, (K,), jnp.float32)))
    np.testing.assert_allclose(log_u[0].numpy(), jlog_u, rtol=1e-6, atol=0)
    lanes = rng.chunk_draws_lanes(key[None], 1, K, 4, torch.float32)
    single = rng.chunk_draws(key, 1, K, 4, torch.float32)
    for a, b in zip(lanes, single):
        assert torch.equal(a[0], b)


def test_threefry_counter_high_word_matches_jax():
    """JAX's counter is a uint64 in two uint32 words (`iota_2x32_shape`);
    the port's `_counts` gives both, and threefry takes the high word as
    x0: against JAX's threefry primitive with high words set."""
    from jax.extend.random import threefry2x32_p

    hi = np.array([0, 1, 2, 0xFFFFFFFF, 7], dtype=np.uint32)
    lo = np.array([5, 0, 0xFFFFFFFF, 3, 1 << 31], dtype=np.uint32)
    k0, k1 = np.uint32(0x12345678), np.uint32(0x9ABCDEF0)
    jb1, jb2 = threefry2x32_p.bind(jnp.full(5, k0, jnp.uint32),
                                   jnp.full(5, k1, jnp.uint32),
                                   jnp.asarray(hi), jnp.asarray(lo))
    t = lambda a: torch.tensor(np.asarray(a).astype(np.int64))  # noqa: E731
    b1, b2 = rng.threefry2x32(t([k0] * 5), t([k1] * 5), t(hi), t(lo))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(jb1).astype(np.int64))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jb2).astype(np.int64))
    x0, x1 = rng._counts((3, 4), "cpu")
    assert torch.equal(x0, torch.zeros((3, 4), dtype=torch.int64))
    assert torch.equal(x1, torch.arange(12).reshape(3, 4))


def test_split_chain_supported():
    assert jpallas_rng.split_chain_supported(jax.random.PRNGKey(0))
    assert rng.split_chain_supported(rng.PRNGKey(0, device="cpu"))
    assert rng.split_chain_supported(rng.split(rng.PRNGKey(7, device="cpu"),
                                               3)[2])
    assert rng.split_chain_supported(
        torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64))
    for bad in (torch.tensor([0, 1], dtype=torch.int32),
                torch.zeros(3, dtype=torch.int64),
                torch.zeros((1, 2), dtype=torch.int64),
                torch.tensor([-1, 0], dtype=torch.int64),
                torch.tensor([0, 1 << 32], dtype=torch.int64),
                np.zeros(2, dtype=np.uint32)):
        assert not rng.split_chain_supported(bad)
    # JAX refuses a key that is not raw uint32 (2,) too
    assert not jpallas_rng.split_chain_supported(jnp.zeros(3, jnp.uint32))


def test_positive_to_log_matches_jax():
    v = np.array([1e-300, 1e-8, 0.5, 1.0, 3.0, 1e300])
    close(ttransforms.positive_to_log(torch.tensor(v)),
          jtransforms.positive_to_log(jnp.asarray(v)), 1e-15)
