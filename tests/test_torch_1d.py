"""The 1-D slice end to end — the BFGS kriging plug-in, Laplace, the
sampler, the factor cache and the posterior predict — against the JAX
package at a small MCMC budget, float64 on the CPU, with the same key:

* `sim_1d`'s Matern(5) x Matern(5) with speculative K = 4 (the one-round
  body over `make_mh_round`; its K candidates' Grams go to the small-K
  kernel K5, here its plain twin) and with the K = 1 body (the
  experiments' default);
* `sim_1d_two_families`' Matern(5) x cubic spline with K = 4, including
  the reference's unnormalized cross (`normalized_cross=False`).

Both packages fit with default arguments apart from the budget, so the
plug-in sigma^2 comes from `kriging_mle` on both sides (the default the
port now shares with JAX).

Tolerances: chain counters equal; sigma^2 1e-8 relative (BFGS stopping
point, see test_torch_samplers.py); draws and predictions 1e-8 relative
to max(1, |value|) (every decision of the chain is the same, so they
carry the log-posteriors' roundoff only); the test function, and the ESS
of the same draws, 1e-12.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.eval.functions import test_function_1d as jf1d
from ccgp_tpu.infer.diagnostics import effective_sample_size as jess
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import fit_combined_gp as jfit
from ccgp_tpu.models import predict_combined_gp as jpredict
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.eval.functions import test_function_1d as tf1d
from ccgp_tpu_torch.infer.diagnostics import effective_sample_size as tess
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.convert import (
    fit_from_numpy, laplace_from_numpy, mcmc_from_numpy, mle_from_numpy)
from ccgp_tpu_torch.ops import chol_smallk, kernels as tkern, rng

FAMILIES = {
    "matern_matern": lambda k: (k.matern_family(5.0), k.matern_family(5.0)),
    "matern_spline": lambda k: (k.matern_family(5.0), k.spline_family()),
}
CASES = [("matern_matern", 4), ("matern_spline", 4), ("matern_matern", 0)]
BUDGET = dict(start=(0.0, 1.5, 0.0), n_max=240, samp_size=80,
              net_samp_size=60)


def lhd(n, seed):
    """An n-point Latin hypercube on [0, 1], from a numpy seed."""
    r = np.random.default_rng(seed)
    return ((r.permutation(n) + r.uniform(size=n)) / n)[:, None]


def close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{s}_K{k}" for s, k in CASES])
def runs(request):
    name, K = request.param
    x = lhd(8, seed=3)
    y = np.array(jf1d(jnp.asarray(x[:, 0]), 1))
    x_new = np.linspace(0.0, 1.0, 50)[:, None]
    normalized = name == "matern_matern"
    js = JSpec(*FAMILIES[name](jkern), dim=1)
    ts = TSpec(*FAMILIES[name](tkern), dim=1)

    def jrun(x, y, x_new, key):
        kf, kp = jax.random.split(key)
        fit = jfit(js, x, y, kf, mcmc=JCfg(**BUDGET, speculative=K))
        return fit, jpredict(js, fit, x, x_new, kp,
                             normalized_cross=normalized)

    key = jax.random.PRNGKey(4)
    jf, jp = jax.jit(jrun)(jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(x_new), key)
    launches = chol_smallk.chol_quadratics_smallk.launches
    kf, kp = rng.split(rng.PRNGKey(4, device="cpu"), 2)
    tf = fit_combined_gp(ts, x, y, kf, mcmc=MCMCConfig(**BUDGET,
                                                       speculative=K),
                         device="cpu")
    tp = predict_combined_gp(ts, tf, x, x_new, kp,
                             normalized_cross=normalized, device="cpu")
    assert chol_smallk.chol_quadratics_smallk.launches == launches
    return dict(jf=jf, jp=jp, tf=tf, tp=tp, ts=ts, x=x, x_new=x_new,
                normalized=normalized, kp=np.asarray(jax.random.split(key)[1]))


def test_chain_and_plug_in_match_jax(runs):
    jf, tf = runs["jf"], runs["tf"]
    assert tf.mcmc.n_recorded == int(jf.mcmc.n_recorded)
    assert tf.mcmc.n_proposals == int(jf.mcmc.n_proposals)
    assert tf.mcmc.n_rounds == int(jf.mcmc.n_rounds)
    assert tf.mcmc.converged == bool(jf.mcmc.converged)
    assert tf.chain_ok == bool(jf.chain_ok)
    close(tf.sigma2, jf.sigma2, 1e-8)
    close(tf.mle.theta, jf.mle.theta, 1e-8)
    close(tf.zs, jf.zs, 1e-8)
    close(tf.cache.chol, jf.cache.chol, 1e-8)


def test_predictions_match_jax(runs):
    jp, tp = runs["jp"], runs["tp"]
    for f in ("mean", "lower", "upper", "quant"):
        close(getattr(tp, f), getattr(jp, f), 1e-8)
    assert tp.mean.shape == (50,) and bool(torch.isfinite(tp.mean).all())


def test_min_ess_matches_jax(runs):
    jf, tf = runs["jf"], runs["tf"]
    ref = jess(jnp.asarray(jf.zs)[None])
    # the same draws: deterministic math; each side's own draws: the
    # draws' tolerance
    close(tess(torch.tensor(np.asarray(jf.zs))[None]), ref, 1e-12)
    close(tess(tf.zs[None]), ref, 1e-8)


def test_converted_state_matches(runs):
    """The JAX fit's plug-in and chain carried across by `convert` equal
    the port's own, and the converted fit predicts JAX's numbers."""
    jf, tf = runs["jf"], runs["tf"]
    a = lambda v: np.asarray(v)  # noqa: E731
    mle = mle_from_numpy(*(a(getattr(jf.mle, f)) for f in
                           ("beta", "sigma2", "theta", "nll", "chol")),
                         device="cpu")
    lap = laplace_from_numpy(a(jf.mcmc.laplace.mode), a(jf.mcmc.laplace.cov),
                             a(jf.mcmc.laplace.logpost), device="cpu")
    mc = mcmc_from_numpy(
        **{f: a(getattr(jf.mcmc, f)) for f in (
            "samples", "betas", "logposts", "n_recorded", "n_proposals",
            "n_accepted", "pvalue", "converged", "n_rounds")},
        laplace=lap, device="cpu")
    for f in ("theta", "sigma2", "beta", "nll", "chol"):
        close(getattr(mle, f), getattr(tf.mle, f).numpy(), 1e-8)
    for f in ("n_recorded", "n_proposals", "n_accepted", "n_rounds",
              "converged"):
        assert getattr(mc, f) == getattr(tf.mcmc, f), f
    k = mc.n_recorded
    for f in ("samples", "betas"):
        close(getattr(mc, f)[:k], getattr(tf.mcmc, f)[:k].numpy(), 1e-8)
    close(mc.laplace.cov, tf.mcmc.laplace.cov.numpy(), 1e-8)
    fit = fit_from_numpy(
        sigma2=a(jf.sigma2), zs=a(jf.zs), p=a(jf.params.p),
        theta1=a(jf.params.theta1), theta2=a(jf.params.theta2),
        chol=a(jf.cache.chol), a=a(jf.cache.a), u=a(jf.cache.u),
        beta=a(jf.cache.beta), y=a(jf.y), jitter=a(jf.jitter), mle=mle,
        mcmc=mc, chain_ok=a(jf.chain_ok), device="cpu")
    assert fit.mcmc.n_recorded == k and fit.chain_ok == tf.chain_ok
    pred = predict_combined_gp(runs["ts"], fit, runs["x"], runs["x_new"],
                               torch.as_tensor(runs["kp"].astype(np.int64)),
                               normalized_cross=runs["normalized"],
                               device="cpu")
    for f in ("mean", "lower", "upper", "quant"):
        close(getattr(pred, f), getattr(runs["jp"], f), 1e-10)


def test_default_mle_method_is_bfgs_as_in_jax():
    """The repair: with default arguments both packages fit sigma^2 by the
    multistart BFGS (`kriging_mle`); the runs above compare the sigma^2
    that default gives."""
    assert (inspect.signature(fit_combined_gp).parameters["mle_method"]
            .default == "bfgs")
    assert (inspect.signature(jfit).parameters["mle_method"].default
            == "bfgs")


@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_function_1d_matches_jax(code):
    x = np.concatenate([np.linspace(0, 1, 37), [0.5]])
    close(tf1d(torch.tensor(x[:, None]), code), jf1d(jnp.asarray(x), code),
          1e-12)
