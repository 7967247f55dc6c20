"""The port's inference pieces against the JAX package, float64 on the CPU:
the grid kriging MLE, BFGS, Laplace and the Geweke diagnostic.

Tolerances: kriging MLE and Geweke 1e-10 relative (deterministic math).
BFGS and Laplace: mode <= 1e-6 absolute, covariance <= 1e-5 relative to
its largest entry. The optimizers stop at gtol = 1e-5 on the gradient's
inf-norm, so the last accepted step — and with it the returned point —
moves with roundoff in the gradients the two autodiff systems compute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.infer import geweke as jgew
from ccgp_tpu.infer.laplace import laplace as jlaplace
from ccgp_tpu.infer.mle import kriging_mle_grid as jmle
from ccgp_tpu.infer.optim import minimize_bfgs as jbfgs
from ccgp_tpu.models import InverseGamma as JIG, LogNormal as JLN
from ccgp_tpu.models import MixtureSpec as JSpec, make_logpost as jlogpost
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.infer import geweke as tgew
from ccgp_tpu_torch.infer import optim
from ccgp_tpu_torch.infer.laplace import laplace as tlaplace
from ccgp_tpu_torch.infer.mle import kriging_mle_grid as tmle
from ccgp_tpu_torch.infer.optim import minimize_bfgs as tbfgs
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.likelihood import make_logpost as tlogpost
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import kernels as tkern


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))),
                                                  1e-300)


@pytest.fixture(scope="module")
def problem():
    r = np.random.default_rng(0)
    x = r.uniform(size=(14, 2))
    y = np.sin(5 * x[:, 0]) + np.cos(3 * x[:, 1])
    return x, y


@pytest.mark.parametrize("jitter", [1e-10, 1e-6])
def test_kriging_mle_grid(problem, jitter):
    x, y = problem
    fam = jkern.sqexp_family()
    mj = jax.jit(lambda a, b: jmle(fam, a, b, jitter=jitter))(
        jnp.asarray(x), jnp.asarray(y))
    mt = tmle(tkern.sqexp_family(), t(x), t(y), jitter=jitter)
    for f in ("beta", "sigma2", "theta", "nll", "chol"):
        assert rel_err(getattr(mt, f), getattr(mj, f)) <= 1e-10, f


def _rosen(lib):
    def f(z):
        return (1.0 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2 \
            + 0.5 * (z[2] - 0.3) ** 2
    return f


def _guarded(lib):
    # NaN outside a ball: the guard turns it into 1e10 with zero gradient
    sqrt = jnp.sqrt if lib == "jax" else torch.sqrt

    def f(z):
        r2 = z[0] ** 2 + z[1] ** 2
        return (z[0] - 0.5) ** 2 + 3.0 * (z[1] + 0.25) ** 2 + 0.0 * sqrt(4.0 - r2)
    return f


@pytest.mark.parametrize("fn", [_rosen, _guarded], ids=["rosenbrock", "guard"])
def test_bfgs(fn):
    x0 = np.array([-1.2, 1.0, 0.0]) if fn is _rosen else np.array([1.9, 0.5])
    xj, fj = jbfgs(fn("jax"), jnp.asarray(x0), maxiter=100)
    xt, ft = tbfgs(fn("torch"), t(x0), maxiter=100)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_guard_without_a_branch(dtype):
    """The guard that needs no read-back: a non-finite value gives 1e10
    and a zero gradient, non-finite gradient entries are zeroed, and
    finite values pass bit for bit."""
    g = torch.tensor([0.1, -3.7e-5, float("nan"), float("inf"), 2.5],
                     dtype=dtype)
    for bad in (float("nan"), float("inf"), -float("inf")):
        v, gv = optim._guard(torch.tensor(bad, dtype=dtype), g)
        assert torch.equal(v, torch.tensor(1e10, dtype=dtype))
        assert torch.equal(gv, torch.zeros_like(g))
    v0 = torch.tensor(-0.123456789, dtype=dtype)
    v, gv = optim._guard(v0, g)
    assert torch.equal(v, v0)
    assert torch.equal(gv, torch.tensor([0.1, -3.7e-5, 0.0, 0.0, 2.5],
                                        dtype=dtype))
    # through the evaluation: the gradient is taken whatever the value
    x = torch.tensor([0.3, -0.2], dtype=dtype)
    v, gv = optim._value_and_grad(lambda z: torch.sum(z * z), x)
    assert torch.equal(v, torch.sum(x * x)) and torch.equal(gv, 2 * x)
    v, gv = optim._value_and_grad(
        lambda z: torch.sum(z) + torch.sqrt(z[0] - 1.0), x)    # NaN
    assert torch.equal(v, torch.tensor(1e10, dtype=dtype))
    assert torch.equal(gv, torch.zeros_like(x))


def test_laplace(problem):
    x, y = problem
    js = JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2,
               rough="tied", anisotropic=True)
    ts = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2,
               rough="tied", anisotropic=True)
    lj = jlogpost(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(0.05),
                  theta1_prior=JLN(-1.0, 1.0), theta2_prior=JIG(3, 4),
                  jitter=1e-6)
    lt = tlogpost(ts, t(x), t(y), t(0.05),
                  theta1_prior=LogNormal(-1.0, 1.0),
                  theta2_prior=InverseGamma(3, 4), jitter=1e-6)
    start = np.array([1.0, 1.0, 0.0, 0.0])
    fj = jax.jit(lambda s: jlaplace(lambda z: lj(z).val, s))(jnp.asarray(start))
    ft = tlaplace(lambda z: lt(z).val, t(start))
    np.testing.assert_allclose(ft.mode.numpy(), np.asarray(fj.mode), rtol=0,
                               atol=1e-6)
    assert rel_err(ft.cov, fj.cov) <= 1e-5
    assert abs(float(ft.logpost) - float(fj.logpost)) <= 1e-8 * abs(
        float(fj.logpost))
    # the logpost itself is deterministic math: 1e-10 relative
    for z in (start, np.asarray(fj.mode)):
        assert rel_err(lt(t(z)).val, lj(jnp.asarray(z)).val) <= 1e-10
        assert rel_err(lt(t(z)).beta, lj(jnp.asarray(z)).beta) <= 1e-10


def _ar1(n, dim, rho, seed):
    r = np.random.default_rng(seed)
    e = r.normal(size=(n, dim))
    x = np.zeros((n, dim))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + e[i]
    return x


@pytest.mark.parametrize("rho,seed", [(0.0, 0), (0.6, 1), (0.95, 2)])
def test_geweke(rho, seed):
    s = _ar1(240, 4, rho, seed)
    assert rel_err(tgew.geweke_pvalue(t(s)),
                   jax.jit(jgew.geweke_pvalue)(jnp.asarray(s))) <= 1e-10
    assert rel_err(tgew.geweke_z(t(s)),
                   jax.jit(jax.vmap(jgew.geweke_z))(jnp.asarray(s.T))) <= 1e-10
    spec0 = jax.jit(jgew.spectrum0_ar)
    for col in range(2):
        assert rel_err(tgew.spectrum0_ar(t(s[:, col])),
                       spec0(jnp.asarray(s[:, col]))) <= 1e-10
