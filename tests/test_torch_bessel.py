"""The port's Bessel K_v (`ccgp_tpu_torch/ops/bessel.py`) against the JAX
package's, float64 on the CPU, and the Laplace step of a Matern fit, whose
Hessian runs forward-over-reverse through K_v.

Tolerances: values 1e-12 relative (both sides run the same fixed-trip
series and continued fraction; the last place moves with the order of a
few divisions). First derivatives 1e-12 relative to JAX's JVP (the same
closed-form rule). The Laplace mode and covariance 1e-8: BFGS stops at
gtol 1e-5, and the returned point moves with roundoff in the gradients the
two autodiff systems compute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.infer.laplace import laplace as jlaplace
from ccgp_tpu.models import InverseGamma as JIG
from ccgp_tpu.models import MixtureSpec as JSpec, make_logpost as jlogpost
from ccgp_tpu.ops import bessel as jb
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.infer.laplace import laplace as tlaplace
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.likelihood import make_logpost as tlogpost
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import bessel as tb
from ccgp_tpu_torch.ops import kernels as tkern

NUS = [0.5, 1.5, 2.2, 5.0]
# across the x = 2 regime edge and down to 1e-6
XS = np.concatenate([np.geomspace(1e-6, 1.0, 13), [1.9, 1.999999, 2.0,
                                                    2.000001, 2.1],
                     np.linspace(2.5, 40.0, 9)])


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("fn", ["bessel_kve", "bessel_kv", "log_bessel_kv"])
def test_values_match_jax(nu, fn):
    ref = getattr(jb, fn)(nu, jnp.asarray(XS))
    got = getattr(tb, fn)(nu, torch.tensor(XS))
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("nu", NUS)
def test_pair_matches_jax(nu):
    for g, r in zip(tb.bessel_kve_pair(nu, torch.tensor(XS)),
                    jb.bessel_kve_pair(nu, jnp.asarray(XS))):
        assert rel(g, r) <= 1e-12


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("fn", ["bessel_kve", "bessel_kv"])
def test_first_derivatives_match_jax_jvp(nu, fn):
    x = jnp.asarray(XS)
    _, ref = jax.jvp(lambda a: getattr(jb, fn)(nu, a), (x,),
                     (jnp.ones_like(x),))
    xt = torch.tensor(XS, requires_grad=True)
    (grad,) = torch.autograd.grad(getattr(tb, fn)(nu, xt).sum(), xt)
    assert rel(grad, ref) <= 1e-12
    # forward mode takes the same rule
    _, fwd = torch.func.jvp(lambda a: getattr(tb, fn)(nu, a),
                            (torch.tensor(XS),), (torch.ones(len(XS),
                                                             dtype=torch.float64),))
    assert rel(fwd, ref) <= 1e-12


def test_second_derivative_is_finite_and_matches_jax():
    """The Hessian's forward-over-reverse pass differentiates the rule."""
    x = jnp.asarray(XS)
    ref = jax.vmap(jax.grad(jax.grad(lambda a: jb.bessel_kve(5.0, a))))(x)
    got = torch.func.vmap(torch.func.jacfwd(torch.func.grad(
        lambda a: tb.bessel_kve(5.0, a))))(torch.tensor(XS))
    assert bool(torch.isfinite(got).all())
    assert rel(got, ref) <= 1e-9


def test_laplace_of_a_matern_fit_matches_jax():
    r = np.random.default_rng(3)
    x = np.sort(r.uniform(size=8))[:, None]
    y = 0.5 * np.sin(10 * x[:, 0]) + 0.5 * np.cos(15 * x[:, 0])
    js = JSpec(jkern.matern_family(5.0), jkern.matern_family(5.0), dim=1)
    ts = TSpec(tkern.matern_family(5.0), tkern.matern_family(5.0), dim=1)
    lj = jlogpost(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(0.2),
                  theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16))
    lt = tlogpost(ts, torch.tensor(x), torch.tensor(y),
                  torch.tensor(0.2, dtype=torch.float64),
                  theta1_prior=InverseGamma(3, 2),
                  theta2_prior=InverseGamma(5, 16))
    start = np.array([0.0, 1.5, 0.0])
    fj = jax.jit(lambda s: jlaplace(lambda z: lj(z).val, s))(
        jnp.asarray(start))
    ft = tlaplace(lambda z: lt(z).val, torch.tensor(start))
    np.testing.assert_allclose(ft.mode.numpy(), np.asarray(fj.mode), rtol=0,
                               atol=1e-8)
    cov_j = np.asarray(fj.cov)
    assert float(np.max(np.abs(ft.cov.numpy() - cov_j))) <= 1e-8 * float(
        np.max(np.abs(cov_j)))
    assert bool(torch.isfinite(ft.cov).all())
