"""Options of the ported main path that no other port test reaches, against
the JAX package, float64 on the CPU:

- a chunked K = 4 fit with a Jeffreys prior on p (`p_prior`), the prior
  code the fused rounds' candidate model (`CandModel`) carries for p;
- its prediction with `var_scale="marginal"` and `drop_negative_var=False`;
- `kriging_mle(ard=True)`, one rate per input axis;
- `fit_combined_gp(mle_ard=True)`, the plug-in sigma2 from that fit.

JAX on the CPU takes its one-round sampler, the port its chunked driver
with the fused rounds' plain twin; the two are law-equal, so with the same
key they run the same chain (tests/test_torch_combined_gp.py).

Tolerances: chain counters equal. Draws and predictions 1e-7 relative to
max(1, |value|): the Laplace mode agrees to ~1e-8 (BFGS stopping
tolerance) and the proposals inherit that. The ARD fit stops where the
gradient falls below 1e-5: theta 1e-6 relative, and sigma2 and beta, which
move with theta, 1e-6; the profile NLL (flat at the optimum) 1e-10
(tests/test_torch_baselines.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.infer.mle import kriging_mle as jkriging_mle
from ccgp_tpu.models import InverseGamma as JIG, JeffreysUnit as JJU
from ccgp_tpu.models import LogNormal as JLN
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.models import fit_combined_gp as jfit
from ccgp_tpu.models import predict_combined_gp as jpredict
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.infer.mle import kriging_mle
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import (
    MCMCConfig, fit_combined_gp, predict_combined_gp)
from ccgp_tpu_torch.models.priors import InverseGamma, JeffreysUnit, LogNormal
from ccgp_tpu_torch.ops import kernels as tkern, rng

CFG = dict(start=(1.0, 1.0, 0.0, 0.0), n_max=300, samp_size=120,
           net_samp_size=120, speculative=4)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    x = r.uniform(size=(20, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    u = np.linspace(0, 1, 6)
    grid = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    return x, y, grid


def _specs():
    return (JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2,
                  rough="tied", anisotropic=True),
            TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
                  rough="tied", anisotropic=True))


# the two fits: a Jeffreys prior on p with the grid plug-in, and the ARD
# BFGS plug-in with the default priors
FITS = {"p_prior": dict(mle_method="grid", jeffreys=True, mle_ard=False),
        "mle_ard": dict(mle_method="bfgs", jeffreys=False, mle_ard=True)}
PREDICT = dict(var_scale="marginal", drop_negative_var=False)


def _jax_fit(x, y, grid, case):
    js, _ = _specs()
    f = FITS[case]
    priors = dict(theta1_prior=JLN(-1.0, 1.0), theta2_prior=JIG(3, 4))
    if f["jeffreys"]:
        priors["p_prior"] = JJU()

    def run(x, y, grid, key):
        kf, kp = jax.random.split(key)
        fit = jfit(js, x, y, kf, mcmc=JCfg(**CFG), jitter=1e-6,
                   mle_method=f["mle_method"], mle_ard=f["mle_ard"], **priors)
        return fit, jpredict(js, fit, x, grid, kp, **PREDICT)

    return jax.jit(run)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid),
                        jax.random.PRNGKey(3))


def _torch_fit(x, y, grid, case):
    _, ts = _specs()
    f = FITS[case]
    priors = dict(theta1_prior=LogNormal(-1.0, 1.0),
                  theta2_prior=InverseGamma(3, 4))
    if f["jeffreys"]:
        priors["p_prior"] = JeffreysUnit()
    kf, kp = rng.split(rng.PRNGKey(3, device="cpu"), 2)
    fit = fit_combined_gp(ts, t(x), t(y), kf, mcmc=MCMCConfig(**CFG),
                          jitter=1e-6, mle_method=f["mle_method"],
                          mle_ard=f["mle_ard"], device="cpu", **priors)
    return fit, predict_combined_gp(ts, fit, t(x), t(grid), kp, device="cpu",
                                    **PREDICT)


@pytest.mark.parametrize("case", list(FITS))
def test_fit_and_predict_options_match_jax(data, case):
    x, y, grid = data
    jf, jp = _jax_fit(x, y, grid, case)
    tf, tp = _torch_fit(x, y, grid, case)
    for a in ("n_recorded", "n_proposals", "n_rounds"):
        assert getattr(tf.mcmc, a) == int(getattr(jf.mcmc, a)), a
    assert tf.chain_ok == bool(jf.chain_ok)
    close(tf.sigma2, jf.sigma2, 1e-7)
    if FITS[case]["mle_ard"]:
        assert tf.mle.theta.shape == (2,)
        close(tf.mle.theta, jf.mle.theta, 1e-6)
    close(tf.zs, jf.zs, 1e-7)
    for f in ("mean", "lower", "upper", "draw_var"):
        close(getattr(tp, f), getattr(jp, f), 1e-7)
    assert bool(torch.isfinite(tp.mean).all())


def test_kriging_mle_ard_matches_jax():
    r = np.random.default_rng(5)
    x = r.uniform(size=(15, 3))
    y = np.sin(4 * x[:, 0]) + x[:, 1] ** 2 - 0.5 * x[:, 2]
    ref = jkriging_mle(jkern.sqexp_family(), jnp.asarray(x), jnp.asarray(y),
                       jax.random.PRNGKey(2), ard=True)
    got = kriging_mle(tkern.sqexp_family(), t(x), t(y),
                      rng.PRNGKey(2, device="cpu"), ard=True)
    assert got.theta.shape == (3,)
    close(got.theta, ref.theta, 1e-6)
    close(got.nll, ref.nll, 1e-10)
    close(got.sigma2, ref.sigma2, 1e-6)
    close(got.beta, ref.beta, 1e-6)
