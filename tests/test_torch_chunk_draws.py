"""The Metropolis drivers' random stream, `ops.rng.chunk_draws`, on the CPU
(its plain version `chunk_draws_plain`):

* against the JAX chunk body (`ccgp_tpu/infer/metropolis.py:338-375`: a
  scan of `jax.random.split(k, 3)`, then `vmap(jax.random.normal)` and
  `jnp.log(jax.random.uniform)` over the round keys) for rr in {1, 7,
  120}, K in {1, 4, 16}, dim in {1, 4, 9}, float32 and float64 and three
  seeds. Tolerances as `tests/test_torch_rng.py` states them: keys
  integer-equal; normals within 1e-12 (f64) and 1e-6 (f32) absolute (erfinv
  is computed by torch and by XLA with different approximations), and in
  f32, where XLA's erfinv strays in the tails, the port's within 2 ulps of
  the exact value (`_normals_f32`);
  log-uniforms at the normals' tolerance, 1e-12 absolute in f64 and 1e-6
  relative in f32 (the log of the same uniform by torch's and XLA's log,
  which part by an ulp on some inputs: `log` of f64 values ~1 ulp apart
  at rr = 7, K = 16);
* the drivers (`_chunked`, and `_one_round` with K = 1 and K = 4) take
  their stream only from `chunk_draws`: with `rng` seen through a
  namespace that holds nothing else, they run, and their chains equal the
  chains of the per-round calls they replaced (`split`, `normal`,
  `uniform`), draw for draw.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu_torch.infer import metropolis as tmetro_mod
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.convert import laplace_from_numpy
from ccgp_tpu_torch.models.likelihood import (
    make_logpost, make_logpost_batch, make_mh_rounds)
from ccgp_tpu_torch.models.priors import InverseGamma, LogNormal
from ccgp_tpu_torch.ops import kernels, rng

SEEDS = [0, 7, 123456789]


@functools.cache
def _jax_chunk(rr, K, dim, dtype):
    """The JAX chunk body's random stream for rr rounds, jitted per shape."""

    def step(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, (k1, k2)

    def body(key):
        key, (k1s, k2s) = jax.lax.scan(step, key, None, length=rr)
        eps = jax.vmap(lambda k1: jax.random.normal(k1, (K, dim), dtype))(k1s)
        log_u = jax.vmap(lambda k2: jnp.log(
            jax.random.uniform(k2, (K,), dtype=dtype)))(k2s)
        return key, eps, log_u

    return jax.jit(body)


def _normals_f32(eps, jeps, key, rr, K, dim):
    """f32 normals: within 1e-6 of JAX's; where they part by more (the
    tails), the port's within 2 ulps of the exact value, sqrt(2) erfinv in
    float64 of the same float32 uniform. XLA's float32 erfinv is ~100 ulps
    off there: at u = 0.99983 it gives 3.7571564 for 3.7571781, torch's
    3.757178."""
    far = np.abs(eps.numpy() - jeps) > 1e-6
    if not far.any():
        return
    # the uniforms the normals came from (exact in both: test_torch_rng.py)
    _, k1s, _ = rng.threefry_split_chain_plain(key, rr)
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = rng.uniform(k1s, (K, dim), torch.float32, lo, 1.0)
    exact = np.sqrt(2.0) * torch.special.erfinv(u.double()).numpy()
    got = eps.numpy().astype(np.float64)
    ulp = np.spacing(np.abs(eps.numpy())).astype(np.float64)
    assert (np.abs(got - exact)[far] <= 2 * ulp[far]).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim", [1, 4, 9])
@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("rr", [1, 7, 120])
@pytest.mark.parametrize("seed", SEEDS)
def test_chunk_draws_plain_matches_jax(seed, rr, K, dim, dtype):
    tdt = getattr(torch, dtype)
    key, eps, log_u = rng.chunk_draws(rng.PRNGKey(seed, device="cpu"), rr, K,
                                      dim, tdt)
    jkey, jeps, jlog_u = _jax_chunk(rr, K, dim, dtype)(
        jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    assert eps.shape == (rr, K, dim) and eps.dtype == tdt
    assert log_u.shape == (rr, K) and log_u.dtype == tdt
    tol = 1e-12 if dtype == "float64" else 1e-6
    if dtype == "float64":
        np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), rtol=0,
                                   atol=tol)
    else:
        _normals_f32(eps, np.asarray(jeps), rng.PRNGKey(seed, device="cpu"),
                     rr, K, dim)
    if dtype == "float64":
        np.testing.assert_allclose(log_u.numpy(), np.asarray(jlog_u),
                                   rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(log_u.numpy(), np.asarray(jlog_u),
                                   rtol=tol, atol=0)


def test_chunk_draws_is_its_plain_version_on_the_cpu():
    key = rng.PRNGKey(3, device="cpu")
    before = rng.chunk_draws.launches
    got = rng.chunk_draws(key, 20, 4, 4, torch.float32)
    assert rng.chunk_draws.launches == before
    for g, r in zip(got, rng.chunk_draws_plain(key, 20, 4, 4, torch.float32)):
        assert torch.equal(g, r)
    # the keys are the split chain's
    new_key, _, _ = rng.threefry_split_chain(key, 20)
    assert torch.equal(got[0], new_key)


def test_chunk_draws_rejects_bad_inputs():
    key = rng.PRNGKey(0, device="cpu")
    for rr, K, dim in ((0, 4, 4), (3, 0, 4), (3, 4, 0)):
        with pytest.raises(ValueError):
            rng.chunk_draws(key, rr, K, dim, torch.float64)
    with pytest.raises(TypeError):
        rng.chunk_draws(key, 3, 4, 4, torch.float16)
    with pytest.raises(ValueError):
        rng.chunk_draws(torch.zeros(3, dtype=torch.int64), 3, 4, 4)
    # a key on another device is refused, never silently computed
    with pytest.raises(ValueError):
        rng.chunk_draws(key.to("meta"), 3, 4, 4)


# ---------------------------------------------------------------------------
# the drivers take their random stream from chunk_draws alone
# ---------------------------------------------------------------------------

def _old_stream(key, rr, K, dim, dtype):
    """The calls the drivers made before `chunk_draws`, shaped as its
    output: the chunked driver's split chain with batched draws; the
    one-round bodies' `split(key, 3)` with `normal(k1, (K, dim))` and
    `uniform(k2, (K,))`, or `normal(k1, (dim,))` and `uniform(k2, ())`
    for K = 1."""
    if rr > 1:
        key, k1s, k2s = rng.threefry_split_chain(key, rr)
        return (key, rng.normal(k1s, (K, dim), dtype),
                torch.log(rng.uniform(k2s, (K,), dtype)))
    ch = rng.split(key, 3)
    if K == 1:
        eps = rng.normal(ch[1], (dim,), dtype)
        log_u = torch.log(rng.uniform(ch[2], (), dtype))
    else:
        eps = rng.normal(ch[1], (K, dim), dtype)
        log_u = torch.log(rng.uniform(ch[2], (K,), dtype))
    return ch[0], eps.reshape(1, K, dim), log_u.reshape(1, K)


@pytest.fixture(scope="module")
def chain_problem():
    r = np.random.default_rng(11)
    x = torch.tensor(r.uniform(size=(12, 2)))
    y = torch.sin(5 * x[:, 0]) + torch.cos(3 * x[:, 1])
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    pri = dict(theta1_prior=LogNormal(0.0, 1.0),
               theta2_prior=InverseGamma(3, 4), jitter=1e-8)
    args = (spec, x, y, torch.tensor(0.3, dtype=torch.float64))
    fit = laplace_from_numpy([1.0, 2.0, 0.0], np.diag([0.2, 0.3, 0.4]), 0.0,
                             device="cpu")
    return dict(args=args, pri=pri, lp=make_logpost(*args, **pri), fit=fit)


@pytest.mark.parametrize("route", ["chunked", "one_round_k1",
                                   "one_round_k4"])
def test_drivers_draw_only_through_chunk_draws(chain_problem, monkeypatch,
                                               route):
    p = chain_problem
    args, pri, lp, fit = p["args"], p["pri"], p["lp"], p["fit"]
    run = dict(n_max=120, samp_size=40, batch_size=20, laplace_fit=fit)
    if route == "chunked":
        run.update(speculative=4, mh_rounds=make_mh_rounds(*args, **pri),
                   rounds_per_call=20, rounds_per_call_warm=24)
    elif route == "one_round_k4":
        run.update(speculative=4,
                   logpost_batch=make_logpost_batch(*args, **pri))
    calls = []

    def counted(stream):
        def fn(key, rr, K, dim, dtype):
            calls.append((rr, K, dim))
            return stream(key, rr, K, dim, dtype)
        return fn

    key = rng.PRNGKey(5, device="cpu")
    chains = {}
    for name, stream in (("chunk_draws", rng.chunk_draws),
                         ("old", _old_stream)):
        # the drivers see an `rng` with nothing but chunk_draws
        monkeypatch.setattr(tmetro_mod, "rng",
                            SimpleNamespace(chunk_draws=counted(stream)))
        calls.clear()
        chains[name] = tmetro_mod.metropolis(lp, fit.mode, key, **run)
        monkeypatch.undo()
        if name == "chunk_draws":
            res = chains[name]
            # one call per chunk (20 or 24 rounds), or per round
            if route == "chunked":
                assert {c[0] for c in calls} <= {20, 24}
                assert sum(c[0] for c in calls) >= res.n_rounds
            else:
                assert len(calls) == res.n_rounds
                assert {c[0] for c in calls} == {1}
            K = 1 if route == "one_round_k1" else 4
            assert {c[1:] for c in calls} == {(K, 3)}
    a, b = chains["chunk_draws"], chains["old"]
    assert a.n_recorded > run["samp_size"]
    for f in ("n_recorded", "n_proposals", "n_accepted", "n_rounds",
              "converged", "pvalue"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("samples", "betas", "logposts"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# fold_in and the lanes launch's plain version
# ---------------------------------------------------------------------------

FOLD_DATA = [0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]


@pytest.mark.parametrize("data", FOLD_DATA)
@pytest.mark.parametrize("seed", SEEDS + [2 ** 40 + 5])
def test_fold_in_matches_jax_bits(seed, data):
    got = rng.fold_in(rng.PRNGKey(seed, device="cpu"), data)
    ref = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_fold_in_over_a_batch_of_keys_and_refusals():
    keys = rng.split(rng.PRNGKey(9, device="cpu"), 5)
    jkeys = jax.random.split(jax.random.PRNGKey(9), 5)
    got = rng.fold_in(keys, 7)
    ref = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 7))(jkeys))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    for bad in (-1, 2 ** 32):
        with pytest.raises(ValueError):
            rng.fold_in(keys[0], bad)


def _single_lanes(keys, rr, K, dim, dtype):
    outs = [rng.chunk_draws_plain(k, rr, K, dim, dtype) for k in keys]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rr,K,dim", [(1, 1, 3), (7, 1, 3), (120, 1, 3),
                                      (7, 4, 4), (20, 16, 1)])
@pytest.mark.parametrize("lanes", [1, 5])
def test_chunk_draws_lanes_plain_is_l_single_calls(lanes, rr, K, dim, dtype):
    keys = rng.split(rng.PRNGKey(123, device="cpu"), lanes)
    got = rng.chunk_draws_lanes_plain(keys, rr, K, dim, dtype)
    ref = _single_lanes(keys, rr, K, dim, dtype)
    assert got[1].shape == (lanes, rr, K, dim) and got[2].shape == (lanes,
                                                                    rr, K)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_chunk_draws_lanes_at_the_sweeps_shape():
    """100 lanes, 120 rounds, K = 1, dim = 3: the sweep's launch."""
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 100)
    for dtype in (torch.float32, torch.float64):
        got = rng.chunk_draws_lanes(keys, 120, 1, 3, dtype)
        for g, r in zip(got, _single_lanes(keys, 120, 1, 3, dtype)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chunk_draws_lanes_matches_jax_vmap(dtype):
    """Against `jax.vmap` of the JAX chunk body over the lanes' keys."""
    rr, K, dim, lanes = 7, 1, 3, 4
    keys = rng.split(rng.PRNGKey(17, device="cpu"), lanes)
    jkeys = jax.random.split(jax.random.PRNGKey(17), lanes)
    key, eps, log_u = rng.chunk_draws_lanes(keys, rr, K, dim,
                                            getattr(torch, dtype))
    jkey, jeps, jlog_u = jax.vmap(_jax_chunk(rr, K, dim, dtype))(jkeys)
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    if dtype == "float64":
        np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(log_u.numpy(), np.asarray(jlog_u),
                                   rtol=0, atol=1e-12)
    else:
        for i in range(lanes):
            _normals_f32(eps[i], np.asarray(jeps[i]), keys[i], rr, K, dim)
        np.testing.assert_allclose(log_u.numpy(), np.asarray(jlog_u),
                                   rtol=1e-6, atol=0)


def test_chunk_draws_lanes_is_its_plain_version_on_the_cpu():
    keys = rng.split(rng.PRNGKey(3, device="cpu"), 3)
    before = rng.chunk_draws_lanes.launches
    got = rng.chunk_draws_lanes(keys, 20, 1, 3, torch.float64)
    assert rng.chunk_draws_lanes.launches == before
    for g, r in zip(got, rng.chunk_draws_lanes_plain(keys, 20, 1, 3,
                                                     torch.float64)):
        assert torch.equal(g, r)


def test_chunk_draws_lanes_rejects_bad_inputs():
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 2)
    for rr, K, dim in ((0, 1, 3), (3, 0, 3), (3, 1, 0)):
        with pytest.raises(ValueError):
            rng.chunk_draws_lanes(keys, rr, K, dim, torch.float64)
    with pytest.raises(TypeError):
        rng.chunk_draws_lanes(keys, 3, 1, 3, torch.float16)
    for bad in (keys[0], keys[:0], keys.to(torch.int32)):
        with pytest.raises(ValueError):
            rng.chunk_draws_lanes(bad, 3, 1, 3)
    with pytest.raises(ValueError):
        rng.chunk_draws_lanes(keys.to("meta"), 3, 1, 3)


@pytest.mark.parametrize("draw_rounds", [7, 120])
def test_lanes_driver_draws_only_through_chunk_draws_lanes(
        chain_problem, monkeypatch, draw_rounds):
    """`metropolis_lanes` takes its stream from `chunk_draws_lanes` alone,
    LANES_DRAW_ROUNDS rounds per call, and its chains do not depend on
    that size: the same chains for 7 and 120."""
    p = chain_problem
    lp, fit = p["lp"], p["fit"]
    lanes = 3
    fits = type(fit)(*(torch.stack([f] * lanes) for f in fit))
    keys = rng.split(rng.PRNGKey(5, device="cpu"), lanes)
    calls = []

    def counted(keys, rr, K, dim, dtype):
        calls.append((keys.shape[0], rr, K, dim))
        return rng.chunk_draws_lanes(keys, rr, K, dim, dtype)

    monkeypatch.setattr(tmetro_mod, "rng",
                        SimpleNamespace(chunk_draws_lanes=counted))
    monkeypatch.setattr(tmetro_mod, "LANES_DRAW_ROUNDS", draw_rounds)
    res = tmetro_mod.metropolis_lanes(lp, fits.mode, keys, n_max=120,
                                      samp_size=40, laplace_fits=fits)
    monkeypatch.undo()
    assert {c[1:] for c in calls} == {(draw_rounds, 1, 3)}
    assert {c[0] for c in calls} == {lanes}
    assert len(calls) == -(-int(res.n_rounds.max()) // draw_rounds)
    ref = tmetro_mod.metropolis_lanes(lp, fits.mode, keys, n_max=120,
                                      samp_size=40, laplace_fits=fits)
    np.testing.assert_array_equal(res.n_proposals, ref.n_proposals)
    assert torch.equal(res.samples, ref.samples)
