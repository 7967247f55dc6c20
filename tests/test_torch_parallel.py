"""`parallel/` against the JAX package, float64 on the CPU.

Each sharded function of the port against JAX's on a one-device mesh
within 1e-10 relative (PARITY.md's tier for deterministic float64 math;
`tests/test_parallel.py` holds JAX's sharded against its serial calls at
1e-12 and 1e-10, and across the packages the Grams at jitter 1e-8 and
the 1e-5 log-posteriors part by up to 7e-12), and the port's 8-device mesh
`["cpu"] * 8` against its one-device mesh: the same split, pad (13 draws
-> 16, 10 designs -> 16) and gather code, so the two agree exactly. JAX's
chains against the port's: equal counters and draws within 1e-10
(`tests/test_torch_samplers.py`'s K = 1 body, vmapped here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu import parallel as jpar
from ccgp_tpu.models import InverseGamma as JIG, MixtureSpec as JSpec
from ccgp_tpu.models import make_logpost as jlogpost
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch import parallel as tpar
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.likelihood import make_logpost, make_logpost_lanes
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng as trng

CPU8 = ["cpu"] * 8


def _tspec():
    return TSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)


def _jspec():
    return JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture
def meshes():
    return (tpar.make_mesh(devices=CPU8), tpar.make_mesh(devices=["cpu"]),
            jpar.make_mesh(1))


def _rel(a, b, floor=1e-300):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_shapes_match_jax(n):
    mesh = tpar.make_mesh(devices=CPU8[:n])
    assert mesh.shape == dict(jpar.make_mesh(n).shape)
    assert mesh.size == n and len(mesh.device_list) == n
    assert tpar.make_mesh(2, devices=CPU8).shape == {"dp": 2, "mp": 1}
    assert tpar.make_mesh(devices=CPU8, shape=(2, 4)).shape == {"dp": 2,
                                                                "mp": 4}
    assert tpar.data_sharding(mesh).axes == ("dp",)
    assert tpar.replicated(mesh).axes == ()


def test_make_mesh_counts_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="1 CUDA device.* 0 present"):
        tpar.make_mesh(1)
    with pytest.raises(RuntimeError, match="0 present"):
        tpar.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 CUDA device.* 2 present"):
        tpar.make_mesh(4)
    mesh = tpar.make_mesh()
    assert [str(d) for d in mesh.device_list] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError):
        tpar.make_mesh(9, devices=CPU8)


@pytest.mark.parametrize("m,mult", [(13, 8), (16, 8), (3, 1), (1, 4)])
def test_pad_to_matches_jax(m, mult):
    a = np.arange(m * 2, dtype=np.float64).reshape(m, 2)
    from ccgp_tpu.parallel.sharded import _pad_to as jpad
    from ccgp_tpu_torch.parallel.sharded import _pad_to as tpad

    got, n = tpad(_t(a), mult)
    ref, nj = jpad(jnp.asarray(a), mult)
    assert n == nj == m
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    return dict(x=r.uniform(size=(10, 2)), y=r.normal(size=10),
                xt=r.uniform(size=(6, 2)), zs=0.2 * r.normal(size=(13, 3)),
                betas=0.1 * r.normal(size=13),
                designs=r.uniform(size=(10, 9, 2)),
                x_eval=r.uniform(size=(16, 2)))


def test_sharded_hyperpar_scan(meshes, data):
    m8, m1, j1 = meshes
    grid = np.array([[3.0, 2.0, 5.0, 16.0], [3.0, 1.0, 5.0, 75.0],
                     [7.0, 3.0, 3.0, 28.0]])
    pars, likes = jpar.sharded_hyperpar_scan(
        _jspec(), jnp.asarray(data["x"]), jnp.asarray(data["y"]), grid, 1.0,
        j1, n_nodes=64, tau=50.0)
    outs = [tpar.sharded_hyperpar_scan(_tspec(), _t(data["x"]),
                                       _t(data["y"]), grid, 1.0, m,
                                       n_nodes=64, tau=50.0)
            for m in (m1, m8)]
    assert _rel(outs[0][1], likes) < 1e-10
    np.testing.assert_array_equal(outs[0][0], np.asarray(pars))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])


def test_sharded_posterior_predict(meshes, data):
    m8, m1, j1 = meshes
    ref = jpar.sharded_posterior_predict(
        _jspec(), *(jnp.asarray(data[k]) for k in ("x", "y", "xt", "zs",
                                                    "betas")), 0.7, j1,
        jitter=1e-8)
    outs = [tpar.sharded_posterior_predict(
        _tspec(), *(_t(data[k]) for k in ("x", "y", "xt", "zs", "betas")),
        0.7, m, jitter=1e-8) for m in (m1, m8)]
    dm, dv, mu0 = outs[0]
    assert dm.shape == (13, 6) and dv.shape == (13, 6) and mu0.shape == (6,)
    assert _rel(dm, ref[0]) < 1e-10 and _rel(mu0, ref[2]) < 1e-10
    # a variance near 0 is the cancellation 1 - r'R^-1 r: relative to
    # max(|v|, sigma^2)
    assert _rel(dv, ref[1], floor=0.7) < 1e-10
    for a, b in zip(outs[1], outs[0]):
        assert torch.equal(a, b)


def _jfit_one(design, key):
    lp = jlogpost(_jspec(), design, jnp.sin(5.0 * design[:, 0]), 0.5,
                  theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16),
                  jitter=1e-5)
    return lp(0.1 * jax.random.normal(key, (3,), design.dtype)).val


def _tfit(designs, keys):
    lp = make_logpost_lanes(_tspec(), designs,
                            torch.sin(5.0 * designs[..., 0]), 0.5,
                            theta1_prior=InverseGamma(3, 2),
                            theta2_prior=InverseGamma(5, 16), jitter=1e-5)
    return lp(0.1 * trng.normal(keys, (3,), designs.dtype)).val


def test_sharded_design_sweep(meshes, data):
    m8, m1, j1 = meshes
    keys = jax.random.split(jax.random.PRNGKey(0), 10)
    ref = jpar.sharded_design_sweep(_jfit_one, jnp.asarray(data["designs"]),
                                    keys, j1)
    tkeys = trng.split(trng.PRNGKey(0, device="cpu"), 10)
    outs = [tpar.sharded_design_sweep(_tfit, _t(data["designs"]), tkeys, m,
                                      batched=True) for m in (m1, m8)]
    assert outs[0].shape == (10,)
    assert _rel(outs[0], ref) < 1e-10
    assert torch.equal(outs[1], outs[0])

    # a fit returning a tuple of tensors and arrays is gathered field by
    # field
    def pair(designs, keys):
        v = _tfit(designs, keys)
        return v, v.numpy() * 2

    v, w = tpar.sharded_design_sweep(pair, _t(data["designs"]), tkeys, m8,
                                     batched=True)
    assert torch.equal(v, outs[0]) and np.array_equal(w, 2 * v.numpy())


def test_multi_chain_metropolis(meshes, data):
    m8, m1, j1 = meshes
    x, y = data["x"][:8], data["y"][:8]
    starts = np.tile([0.0, 1.0, 0.0], (6, 1))
    run = dict(n_max=200, samp_size=100, alpha_geweke=0.9)
    jlp = jlogpost(_jspec(), jnp.asarray(x), jnp.asarray(y), 1.0,
                   theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16))
    ref = jpar.multi_chain_metropolis(
        jlp, jnp.asarray(starts), jax.random.split(jax.random.PRNGKey(0), 6),
        j1, **run)
    tlp = make_logpost(_tspec(), _t(x), _t(y), 1.0,
                       theta1_prior=InverseGamma(3, 2),
                       theta2_prior=InverseGamma(5, 16))
    keys = trng.split(trng.PRNGKey(0, device="cpu"), 6)
    outs = [tpar.multi_chain_metropolis(tlp, _t(starts), keys, m, **run)
            for m in (m1, m8)]
    res = outs[0]
    assert res.samples.shape == (6, 200, 3)
    for f in ("n_recorded", "n_proposals", "n_accepted"):
        np.testing.assert_array_equal(getattr(res, f),
                                      np.asarray(getattr(ref, f)))
    for i in range(6):
        k = int(res.n_recorded[i])
        np.testing.assert_allclose(res.samples[i, :k].numpy(),
                                   np.asarray(ref.samples[i, :k]), rtol=0,
                                   atol=1e-10)
    for f in ("n_recorded", "n_proposals", "pvalue"):
        np.testing.assert_array_equal(getattr(outs[1], f), getattr(res, f))
    assert torch.equal(outs[1].samples, res.samples)
    # chains are independent: different keys -> different draws
    assert not torch.allclose(res.samples[0], res.samples[1])
    # a shard on a device the port does not run chains on is refused
    with pytest.raises(NotImplementedError):
        tpar.multi_chain_metropolis(tlp, _t(starts), keys,
                                    tpar.make_mesh(devices=["cpu", "meta"]),
                                    **run)


def _jstep(mesh, data, steps):
    step, make_state = jpar.distributed_train_step(
        _jspec(), jnp.asarray(data["x"][:8]), jnp.asarray(data["y"][:8]),
        jnp.asarray(data["x_eval"]), 1.0, 0.1 * jnp.eye(3), mesh,
        theta1_prior=JIG(3, 2), theta2_prior=JIG(5, 16), jitter=1e-6)
    state = make_state(jax.random.PRNGKey(0), 8, jnp.asarray([0.0, 1.0, 0.0]))
    for _ in range(steps):
        state, metrics = step(state)
    return state, metrics


def _tstep(mesh, data, steps, n_chains=8):
    step, make_state = tpar.distributed_train_step(
        _tspec(), _t(data["x"][:8]), _t(data["y"][:8]), _t(data["x_eval"]),
        1.0, 0.1 * torch.eye(3, dtype=torch.float64), mesh,
        theta1_prior=InverseGamma(3, 2), theta2_prior=InverseGamma(5, 16),
        jitter=1e-6)
    state = make_state(trng.PRNGKey(0, device="cpu"), n_chains,
                       _t([0.0, 1.0, 0.0]))
    for _ in range(steps):
        state, metrics = step(state)
    return state, metrics


def test_distributed_train_step(meshes, data):
    m8, m1, j1 = meshes
    jstate, jm = _jstep(j1, data, 3)
    outs = [_tstep(m, data, 3) for m in (m1, m8)]
    state, metrics = outs[0]
    assert metrics["grid_mean"].shape == (16,)
    assert _rel(state.z, jstate.z) < 1e-10
    assert _rel(state.lp, jstate.lp) < 1e-10
    np.testing.assert_array_equal(state.key.numpy(),
                                  np.asarray(jstate.key).astype(np.int64))
    np.testing.assert_array_equal(state.accepts.numpy(),
                                  np.asarray(jstate.accepts))
    for k in ("acc_rate", "mean_logpost", "grid_mean"):
        assert _rel(metrics[k], jm[k]) < 1e-10, k
    s8, met8 = outs[1]
    for a, b in zip(s8, state):
        assert torch.equal(a, b)
    for k in metrics:
        assert torch.equal(met8[k], metrics[k])


def test_distributed_train_step_pads_a_ragged_chain_count(meshes, data):
    """11 chains on 8 devices pad to 16 and are cut back to 11: chain i is
    the same as in a one-device run."""
    m8, m1, _ = meshes
    s8, met8 = _tstep(m8, data, 2, n_chains=11)
    s1, met1 = _tstep(m1, data, 2, n_chains=11)
    assert s8.z.shape == (11, 3)
    for a, b in zip(s8, s1):
        assert torch.equal(a, b)
    assert torch.equal(met8["grid_mean"], met1["grid_mean"])
