"""The batched Cholesky kernels K3 (`chol_quadratics_lanes`) and K4
(`chol_factors_lanes`): their plain twins against the JAX package's Pallas
kernels in interpret mode, float64 on the CPU, and the `chol_quadratics`
dispatcher's routing.

Tolerance: 1e-10 relative to max(1, |value|). The twin and the Pallas
body run the same right-looking loop; they differ in the order of the
final quadratic sums (the twin accumulates pivot by pivot, the TPU kernel
reduces at the end) and in the TPU kernel's identity padding. With an
absolute jitter of 1e-3 the Grams' condition numbers stay below ~1e5, so
that roundoff stays near 1e-11.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.ops import pallas_chol_lanes as jlanes
from ccgp_tpu.ops.pallas_chol import chol_quadratics as jchol_quadratics
from ccgp_tpu_torch.ops import chol, chol_lanes

TOL = 1e-10
QUADS = ("logdet", "qyy", "qoy", "qoo")


def grams_batch(b, n, seed=0):
    """(B, n, n) SE Grams on one random design, rates spread over the
    batch (from rough to smooth), and a response y (n,)."""
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    theta = np.exp(np.linspace(0.0, 3.0, b))
    return np.exp(-theta[:, None, None] * d2[None]), r.normal(size=n)


def assert_close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    err = np.abs(got[fin] - ref[fin]) / np.maximum(1.0, np.abs(ref[fin]))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.mark.parametrize("b", [64, 130])
# 8: the kernels' warp path; 33: the first n past it
@pytest.mark.parametrize("n", [8, 17, 33, 100, 128])
def test_quadratics_twin_matches_pallas_interpret(b, n):
    g, y = grams_batch(b, n, seed=n)
    ref = jlanes.chol_quadratics_lanes(jnp.asarray(g), jnp.asarray(y),
                                       jitter=1e-3, interpret=True)
    got = chol_lanes.chol_quadratics_lanes(torch.tensor(g), torch.tensor(y),
                                           jitter=1e-3)
    assert set(got) == set(QUADS)
    for k in QUADS:
        assert_close(got[k], ref[k])


@pytest.mark.parametrize("b", [64, 130])
@pytest.mark.parametrize("n", [8, 17, 33, 100, 128])
def test_factors_twin_matches_pallas_interpret(b, n):
    g, y = grams_batch(b, n, seed=n + 1)
    ref = jlanes.chol_factors_lanes(jnp.asarray(g), jnp.asarray(y),
                                    jitter=1e-3, interpret=True)
    got = chol_lanes.chol_factors_lanes(torch.tensor(g), torch.tensor(y),
                                        jitter=1e-3)
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], ref[k])
    # the factor is lower triangular with exact zeros above the diagonal
    assert torch.equal(got["chol"], torch.tril(got["chol"]))


def indefinite_batch(b, n, seed=3):
    """Odd members: a rank-n/2 Gram minus 1e-2 I, so a pivot turns
    negative (NaN); even members: the same Gram plus 1e-2 I (finite)."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(b, n, n // 2))
    g = v @ np.swapaxes(v, 1, 2) / n
    shift = np.where(np.arange(b) % 2 == 1, -1e-2, 1e-2)
    return g + shift[:, None, None] * np.eye(n), r.normal(size=n)


def test_non_pd_gives_nan_where_pallas_does():
    g, y = indefinite_batch(64, 24)
    ref = jlanes.chol_factors_lanes(jnp.asarray(g), jnp.asarray(y),
                                    interpret=True)
    got = chol_lanes.chol_factors_lanes(torch.tensor(g), torch.tensor(y))
    nan = ~torch.isfinite(got["logdet"])
    assert torch.equal(nan, torch.arange(64) % 2 == 1)
    for k in ref:
        assert_close(got[k], ref[k])
    # the upper triangle stays exactly 0 even where the factor failed
    assert torch.equal(torch.triu(got["chol"], 1),
                       torch.zeros_like(got["chol"]))


def test_only_the_lower_triangle_is_read():
    g, y = grams_batch(64, 21, seed=6)
    junk = g.copy()
    junk[:, np.triu_indices(21, 1)[0], np.triu_indices(21, 1)[1]] = np.nan
    for fn in (chol_lanes.chol_quadratics_lanes,
               chol_lanes.chol_factors_lanes):
        ref = fn(torch.tensor(g), torch.tensor(y), jitter=1e-3)
        got = fn(torch.tensor(junk), torch.tensor(y), jitter=1e-3)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


def test_factor_contract_matches_dense_linalg():
    g, y = grams_batch(65, 33, seed=5)
    f = chol_lanes.chol_factors_lanes(torch.tensor(g), torch.tensor(y),
                                      jitter=1e-3)
    for i in (0, 31, 64):
        want_l = np.linalg.cholesky(g[i] + 1e-3 * np.eye(33))
        assert_close(f["chol"][i], want_l)
        assert_close(f["wy"][i], np.linalg.solve(want_l, y), 1e-9)
        assert_close(f["wo"][i], np.linalg.solve(want_l, np.ones(33)), 1e-9)


@pytest.mark.parametrize("b,n,routed", [
    (64, 20, True), (200, 128, True),   # B >= 64, n <= 128: the lanes kernel
    (32, 20, False), (64, 129, False),  # else the bordered path
])
def test_dispatcher_routes_by_shape(monkeypatch, b, n, routed):
    calls = []
    real = chol_lanes.chol_quadratics_lanes

    def spy(grams, y, jitter=0.0):
        calls.append(tuple(grams.shape))
        return real(grams, y, jitter=jitter)

    monkeypatch.setattr(chol_lanes, "chol_quadratics_lanes", spy)
    g, y = grams_batch(b, n, seed=b + n)
    got = chol.chol_quadratics(torch.tensor(g), torch.tensor(y), jitter=1e-3)
    assert calls == ([(b, n, n)] if routed else [])
    # JAX on the CPU takes its bordered XLA path for every shape; the two
    # factorizations round differently, hence 1e-9
    ref = jchol_quadratics(jnp.asarray(g), jnp.asarray(y), jitter=1e-3)
    for k in QUADS:
        assert_close(got[k], ref[k], 1e-9)


def test_wrappers_check_inputs_and_never_launch_on_cpu():
    g, y = grams_batch(64, 12)
    before = (chol_lanes.chol_quadratics_lanes.launches,
              chol_lanes.chol_factors_lanes.launches)
    chol_lanes.chol_quadratics_lanes(torch.tensor(g), torch.tensor(y))
    chol_lanes.chol_factors_lanes(torch.tensor(g), torch.tensor(y))
    assert (chol_lanes.chol_quadratics_lanes.launches,
            chol_lanes.chol_factors_lanes.launches) == before
    gt, yt = torch.tensor(g), torch.tensor(y)
    with pytest.raises(ValueError):      # n above the kernel's 128
        chol_lanes.chol_quadratics_lanes(torch.zeros(64, 129, 129),
                                         torch.zeros(129))
    with pytest.raises(TypeError):       # y on another dtype
        chol_lanes.chol_factors_lanes(gt, yt.float())
    with pytest.raises(ValueError):      # a device that is neither
        chol_lanes.chol_quadratics_lanes(gt.to("meta"), yt.to("meta"))
