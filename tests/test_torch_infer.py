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


# --- the Geweke wrapper (`ops.geweke`) on the CPU ---------------------------

def _chain_buffer(dtype):
    """A chain buffer as the drivers keep it: rows [z | beta | logpost]."""
    return torch.tensor(_ar1(1300, 6, 0.6, 5), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geweke_wrapper_cpu_takes_the_plain_path(dtype):
    """A CPU window, a strided view of a chain buffer or a batch of windows,
    goes through `infer.geweke.geweke_pvalue` bit for bit, and launches
    nothing."""
    from ccgp_tpu_torch.ops import geweke as ogew

    P = _chain_buffer(dtype)
    before = ogew.geweke_pvalue.launches
    view = P[150:1150, :4]
    got = ogew.geweke_pvalue(view)
    assert got.dtype == dtype and got.shape == ()
    assert torch.equal(got, tgew.geweke_pvalue(view))
    assert torch.equal(ogew.geweke_pvalue(P[:240, :3]),
                       tgew.geweke_pvalue(P[:240, :3]))
    wins = torch.stack([P[f:f + 1000, :4] for f in (0, 150, 300)])
    batch = ogew.geweke_pvalue(wins)
    assert batch.shape == (3,)
    for b in range(3):
        assert torch.equal(batch[b], tgew.geweke_pvalue(wins[b]))
    assert ogew.geweke_pvalue.launches == before


@pytest.mark.parametrize("bad,error", [
    (lambda P: P[:1000, :4].half(), TypeError),
    (lambda P: P[:1000, :4].to(torch.int64), TypeError),
    (lambda P: P[:1000, 0], ValueError),
    (lambda P: P[None, None, :1000, :4], ValueError),
    (lambda P: P[:9, :4], ValueError),             # an empty first part
    (lambda P: P[:1000, :0], ValueError),
    (lambda P: P[:0, :1000].reshape(0, 10, 0), ValueError),
], ids=["half", "int64", "rank1", "rank4", "short", "no_columns",
        "no_windows"])
def test_geweke_wrapper_refuses_what_the_kernel_does_not_take(
        monkeypatch, bad, error):
    """A tensor taken for a CUDA one (the device check mocked): the wrapper
    raises on a dtype, a rank or a shape the kernel does not take, before
    it builds or launches anything."""
    from ccgp_tpu_torch.ops import _build
    from ccgp_tpu_torch.ops import geweke as ogew

    def no_build():
        raise AssertionError("the wrapper tried to build the kernels")

    monkeypatch.setattr(ogew, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "library", no_build)
    before = ogew.geweke_pvalue.launches
    with pytest.raises(error):
        ogew.geweke_pvalue(bad(_chain_buffer(torch.float64)))
    # a window the kernel would take, on a device that is not a card
    with pytest.raises(ValueError, match="unsupported device"):
        ogew.geweke_pvalue(_chain_buffer(torch.float64)[:1000, :4])
    assert ogew.geweke_pvalue.launches == before


@pytest.mark.parametrize("n,dim,elem,warps", [
    (1000, 4, 4, 8), (1000, 3, 8, 6), (240, 19, 8, 16), (240, 1, 8, 2),
    (10000, 3, 8, 5)])
def test_geweke_layout(n, dim, elem, warps):
    """The launch's parts, orders and warps: n1 = int(0.1 n) and n2 =
    int(0.5 n) rows, spectrum0_ar's orders, a warp per (part, column) up
    to what fits one block's shared memory."""
    from ccgp_tpu_torch.ops import geweke as ogew

    n1, n2, km1, km2, w, nbytes = ogew.layout(n, dim, elem)
    assert (n1, n2) == (int(0.1 * n), int(0.5 * n))
    assert (km1, km2) == (min(n1 - 1, int(10 * np.log10(n1))),
                          min(n2 - 1, int(10 * np.log10(n2))))
    assert w == warps
    assert nbytes == (w * (n2 + 4 * (km2 + 1)) + 4 * dim) * elem
    assert nbytes <= ogew.SMEM_BYTES
    with pytest.raises(ValueError):
        ogew.layout(10 ** 6, 3, 8)
