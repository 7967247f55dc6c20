"""The study's two competitor baselines on the CPU, float64, against the
JAX package: the single GP (`models/kriging.kriging_predict`, both
variants, and `infer/mle.mlegp_fit`) and the composite GP
(`models/composite_gp`), plus the 2-D test functions.

Tolerances: at the same inputs (a JAX fit carried across by `convert`,
the same candidate rows) the port runs the same algebra: 1e-10 relative
to max(1, |value|), designs and permutations equal. A fit from scratch
carries the optimizer's stopping point: `mlegp_fit` and JAX's BFGS stop
where the gradient falls below 1e-5, so theta agrees to 1e-6 relative,
the profile NLL (flat at the optimum) to 1e-10 and sigma^2 to 1e-7; the
composite GP's optimum to 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.design.lhs import maximin_lhs as jmaximin
from ccgp_tpu.eval.functions import test_function_2d as jf2d
from ccgp_tpu.eval.functions import test_function_batch as jfbatch
from ccgp_tpu.infer.mle import kriging_mle as jkriging_mle
from ccgp_tpu.infer.mle import mlegp_fit as jmlegp_fit
from ccgp_tpu.models import composite_gp as jcgp
from ccgp_tpu.models.kriging import kriging_predict as jkriging_predict
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.eval.functions import test_function_2d as tf2d
from ccgp_tpu_torch.eval.functions import test_function_batch as tfbatch
from ccgp_tpu_torch.infer.mle import mlegp_fit
from ccgp_tpu_torch.models import composite_gp as tcgp
from ccgp_tpu_torch.models.convert import cgp_from_numpy, mle_from_numpy
from ccgp_tpu_torch.models.kriging import kriging_predict
from ccgp_tpu_torch.ops import kernels as tkern, rng


def close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module")
def data():
    """sim_2d_iso's design for PRNGKey(0), function 2, and a 7 x 7
    lattice."""
    x = np.asarray(jmaximin(jax.random.PRNGKey(0), 14, 2))
    y = np.asarray(jf2d(jnp.asarray(x), 2))
    u = np.linspace(0, 1, 7)
    x_new = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    return x, y, x_new


@pytest.mark.parametrize("variant", ["reference", "mlegp"])
@pytest.mark.parametrize("ard", [False, True])
def test_kriging_predict_at_a_jax_fit(data, variant, ard):
    x, y, x_new = data
    jfit = jkriging_mle(jkern.sqexp_family(), jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(2), ard=ard)
    ref = jkriging_predict(jkern.sqexp_family(), jnp.asarray(x),
                           jnp.asarray(y), jfit, jnp.asarray(x_new),
                           variant=variant)
    fit = mle_from_numpy(*(np.asarray(getattr(jfit, f)) for f in
                           ("beta", "sigma2", "theta", "nll", "chol")),
                         device="cpu")
    got = kriging_predict(tkern.sqexp_family(), torch.tensor(x),
                          torch.tensor(y), fit, torch.tensor(x_new),
                          variant=variant)
    for f in ("mean", "var", "lower", "upper"):
        close(getattr(got, f), getattr(ref, f), 1e-10)
    with pytest.raises(ValueError):
        kriging_predict(tkern.sqexp_family(), torch.tensor(x),
                        torch.tensor(y), fit, torch.tensor(x_new),
                        variant="other")


def test_mlegp_fit_matches_jax(data):
    x, y, _ = data
    ref = jmlegp_fit(jkern.sqexp_family(), jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(3), jitter=0.0)
    got = mlegp_fit(tkern.sqexp_family(), torch.tensor(x), torch.tensor(y),
                    rng.PRNGKey(3, device="cpu"), jitter=0.0)
    close(got.theta, ref.theta, 1e-6)
    close(got.nll, ref.nll, 1e-10)
    close(got.sigma2, ref.sigma2, 1e-7)
    close(got.beta, ref.beta, 1e-7)
    assert got.theta.shape == (2,)


def test_cgp_pieces_at_the_same_inputs(data):
    x, y, _ = data
    xs_j, scales_j = jcgp._standardize(jnp.asarray(x))
    xs_t, scales_t = tcgp._standardize(torch.tensor(x))
    close(xs_t, xs_j, 1e-12)
    close(scales_t, scales_j, 1e-12)
    lo_j, hi_j = jcgp._bounds(xs_j, 2, 0.001, None, None, None, jnp.float64)
    lo_t, hi_t = tcgp._bounds(xs_t, 2)
    close(lo_t, lo_j, 1e-10)
    close(hi_t, hi_j, 1e-10)
    lhd_j = np.asarray(jcgp._lhd(jax.random.PRNGKey(9), 505, 5, jnp.float64))
    lhd_t = tcgp._lhd(rng.PRNGKey(9, device="cpu"), 505, 5, torch.float64)
    assert np.array_equal(lhd_t.numpy(), lhd_j)
    w = lhd_j[:32] * (np.asarray(hi_j) - np.asarray(lo_j)) + np.asarray(lo_j)
    ref = jax.vmap(lambda v: jcgp._objective(v, xs_j, jnp.asarray(y)))(
        jnp.asarray(w))
    close(tcgp._objective(torch.tensor(w), xs_t, torch.tensor(y)), ref,
          1e-10)
    # one row at a time, as the refinement calls it
    close(tcgp._objective(torch.tensor(w[3]), xs_t, torch.tensor(y)),
          ref[3], 1e-10)


def test_cgp_fit_and_predict_match_jax(data):
    x, y, x_new = data
    jfit = jcgp.cgp_fit(jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(3), n_candidates=105)
    jpred = jcgp.cgp_predict(jfit, jnp.asarray(x_new))
    fit = tcgp.cgp_fit(torch.tensor(x), torch.tensor(y),
                       rng.PRNGKey(3, device="cpu"), n_candidates=105)
    for f in jcgp.CGPFit._fields:
        close(getattr(fit, f), getattr(jfit, f), 1e-8)
    pred = tcgp.cgp_predict(fit, torch.tensor(x_new))
    for f in jcgp.CGPPrediction._fields:
        close(getattr(pred, f), getattr(jpred, f), 1e-8)
    # at JAX's own fit, carried across: the same algebra
    carried = cgp_from_numpy(**{f: np.asarray(getattr(jfit, f))
                                for f in jcgp.CGPFit._fields}, device="cpu")
    pred = tcgp.cgp_predict(carried, torch.tensor(x_new))
    for f in jcgp.CGPPrediction._fields:
        close(getattr(pred, f), getattr(jpred, f), 1e-10)
    with pytest.raises(ValueError):
        cgp_from_numpy(x=np.zeros((2, 2)), device="cpu")


@pytest.mark.parametrize("code", [1, 2, 3, 4, 5])
def test_function_2d_matches_jax(code):
    r = np.random.default_rng(code)
    xy = np.concatenate([r.uniform(size=(40, 2)), [[0.5, 0.5]]])
    close(tf2d(torch.tensor(xy), code), jf2d(jnp.asarray(xy), code), 1e-12)
    if code <= 2:
        xb = 2.0 * xy - 1.0
        close(tfbatch(torch.tensor(xb), code), jfbatch(jnp.asarray(xb), code),
              1e-12)
