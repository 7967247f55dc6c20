"""The five public functions the port lacked, on the CPU, float64,
against the JAX package: `utils/stats.mvn_logpdf_chol`, `masked_quantile`
and `batch_se`, `infer/diagnostics.gelman_rubin` (exported from
`ccgp_tpu_torch.infer` as from `ccgp_tpu.infer`) and
`ops/kernels.sqexp_corr`, on the cases of `tests/test_utils_misc.py`,
`tests/test_predict.py` and `tests/test_diagnostics.py`.

Tolerance: 1e-10 relative to max(1, |value|) at the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from ccgp_tpu.infer import gelman_rubin as jgelman_rubin
from ccgp_tpu.ops import kernels as jkern, linalg as jlinalg
from ccgp_tpu.utils import stats as jstats
from ccgp_tpu_torch.infer import gelman_rubin
from ccgp_tpu_torch.ops import kernels as tkern, linalg as tlinalg
from ccgp_tpu_torch.utils import stats as tstats


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, ref, tol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.mark.parametrize("log_scale", [0.0, 0.8, -2.5])
def test_mvn_logpdf_chol_matches_jax_and_scipy(log_scale):
    r = np.random.default_rng(0)
    n = 7
    a = r.normal(size=(n, n))
    cov = a @ a.T + n * np.eye(n)
    y = r.normal(size=n)
    mean = r.normal(size=n)
    got = tstats.mvn_logpdf_chol(t(y), t(mean), tlinalg.jitter_cholesky(
        t(cov)), log_scale)
    ref = jstats.mvn_logpdf_chol(jnp.asarray(y), jnp.asarray(mean),
                                 jlinalg.jitter_cholesky(jnp.asarray(cov)),
                                 log_scale)
    close(got, ref)
    want = scipy.stats.multivariate_normal(
        mean=mean, cov=np.exp(log_scale) * cov).logpdf(y)
    close(got, want, 1e-10)
    # a scalar mean and a tensor log-scale
    got = tstats.mvn_logpdf_chol(t(y), 0.5, tlinalg.jitter_cholesky(t(cov)),
                                 t(log_scale))
    ref = jstats.mvn_logpdf_chol(jnp.asarray(y), 0.5, jlinalg.jitter_cholesky(
        jnp.asarray(cov)), jnp.asarray(log_scale))
    close(got, ref)


@pytest.mark.parametrize("q", [0.0, 0.025, 0.25, 0.5, 0.975, 1.0])
@pytest.mark.parametrize("share", [0.0, 0.3, 0.99, 1.0])
def test_masked_quantile_matches_jax(q, share):
    """Type-7 quantiles of the valid entries; no valid entry gives the
    dtype's largest value in both."""
    r = np.random.default_rng(1)
    x = r.normal(size=100)
    valid = r.uniform(size=100) >= share
    got = tstats.masked_quantile(t(x), t(valid), q)
    close(got, jstats.masked_quantile(jnp.asarray(x), jnp.asarray(valid), q))
    if valid.any():
        close(got, np.quantile(x[valid], q))


def test_masked_quantile_rows():
    """A batch of rows gives each row's quantile (JAX's takes one row)."""
    r = np.random.default_rng(2)
    x = r.normal(size=(4, 50))
    valid = r.uniform(size=(4, 50)) > 0.4
    got = tstats.masked_quantile(t(x), t(valid), 0.3)
    for i in range(4):
        close(got[i], jstats.masked_quantile(jnp.asarray(x[i]),
                                             jnp.asarray(valid[i]), 0.3))


@pytest.mark.parametrize("n,batch_size", [(2000, 20), (2013, 20), (999, 50)])
def test_batch_se_matches_jax(n, batch_size):
    r = np.random.default_rng(3)
    x = r.normal(size=(2, n)).cumsum(axis=-1) * 0.1
    close(tstats.batch_se(t(x), batch_size),
          jstats.batch_se(jnp.asarray(x), batch_size))
    se = float(tstats.batch_se(t(r.normal(size=2000)), 20))
    assert 0.5 / np.sqrt(2000) < se < 2.5 / np.sqrt(2000)


def test_gelman_rubin_matches_jax():
    r = np.random.default_rng(4)
    good = r.normal(size=(4, 1001, 2))
    bad = good + np.arange(4)[:, None, None] * 3.0
    for chains in (good, bad):
        close(gelman_rubin(t(chains)), jgelman_rubin(jnp.asarray(chains)))
    assert bool((gelman_rubin(t(good)) < 1.02).all())
    assert bool((gelman_rubin(t(bad)) > 1.5).all())


def test_sqexp_corr_matches_jax():
    d = np.random.default_rng(5).uniform(0.0, 30.0, size=(6, 9))
    close(tkern.sqexp_corr(t(d)), jkern.sqexp_corr(jnp.asarray(d)))
