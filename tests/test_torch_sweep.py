"""The multi-design sweep and the lane-batched K = 1 sampler behind it,
float64 on the CPU:

* `make_logpost_lanes` lane by lane against `make_logpost` on each design
  (values and betas within 1e-12 relative);
* `metropolis_lanes` lane by lane against the serial `metropolis` on the
  same design, start and key: equal counters, recorded draws within 1e-12
  absolute, log-posteriors within 1e-10 relative and betas within 1e-10
  relative or absolute (a beta near 0 is the difference of two O(1)
  sums; a lane's Gram products run batched, so its roundoff is its own:
  2e-12 measured); a lane frozen by a
  cap while the others run on; record="all"; a resumed Laplace fit;
* `sim_2d_sweep.run` against the JAX package's at n_designs=3,
  n_new_axis=5, n_max=300, samp 100, net 80 on stand-in Train_Designs
  (`chip_smoke.standin_data_root`): per-design RMSPE, coverage and
  quantile within 1e-8 relative, `chain_ok` equal; the same sweep split
  over a two-device CPU mesh;
* the CLI: `sim_2d_sweep --cpu --f64 --fast --designs 3` prints the JAX
  CLI's lines, `--mesh 2 --cpu` the same numbers, and `--mesh 2` without
  `--cpu` raises naming the CUDA device count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ccgp_tpu import __main__ as jcli
from ccgp_tpu.eval import datasets as jdata
from ccgp_tpu.experiments import sim_2d_sweep as jsweep
from ccgp_tpu.models import MCMCConfig as JMCMC
from ccgp_tpu_torch import __main__ as tcli
from ccgp_tpu_torch.eval import datasets as tdata
from ccgp_tpu_torch.experiments import sim_2d_sweep as tsweep
from ccgp_tpu_torch.infer.laplace import LaplaceFit
from ccgp_tpu_torch.infer.metropolis import (
    laplace_lanes, metropolis, metropolis_lanes)
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.likelihood import make_logpost, make_logpost_lanes
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng

PRI = dict(theta1_prior=InverseGamma(3, 2), theta2_prior=InverseGamma(5, 16),
           jitter=1e-5)
SWEEP_MCMC = dict(start=(1.0, 1.0, 0.0), n_max=300, samp_size=100,
                  net_samp_size=80)


def _spec():
    fam = kernels.sqexp_family()
    return MixtureSpec(fam, fam, dim=2)


@pytest.fixture(scope="module")
def lanes_problem():
    g = np.random.default_rng(1)
    xs = torch.tensor(g.uniform(size=(3, 14, 2)))
    ys = torch.sin(5 * xs[..., 0]) + torch.cos(3 * xs[..., 1])
    s2 = torch.tensor([0.5, 0.7, 1.1], dtype=torch.float64)
    keys = rng.split(rng.PRNGKey(0, device="cpu"), 3)
    starts = torch.tensor([[1.0, 1.0, 0.0]] * 3, dtype=torch.float64)
    lp = make_logpost_lanes(_spec(), xs, ys, s2, **PRI)
    serial = [make_logpost(_spec(), xs[i], ys[i], s2[i], **PRI)
              for i in range(3)]
    fits = laplace_lanes(lp, starts)
    return dict(xs=xs, ys=ys, s2=s2, keys=keys, starts=starts, lp=lp,
                serial=serial, fits=fits)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_logpost_lanes_is_make_logpost_per_lane(lanes_problem):
    p = lanes_problem
    zs = torch.tensor([[0.3, 1.2, -0.4], [1.5, 0.2, 0.7],
                       [-0.5, 2.0, 0.1]], dtype=torch.float64)
    out = p["lp"](zs)
    assert out.val.shape == (3,) and out.beta.shape == (3,)
    for i in range(3):
        ref = p["serial"][i](zs[i])
        assert _rel(out.val[i], ref.val) < 1e-12
        assert _rel(out.beta[i], ref.beta) < 1e-12
        lane = p["lp"].lane(i)(zs[i])
        assert torch.equal(lane.val, ref.val)


def test_logpost_lanes_rejects_bad_shapes(lanes_problem):
    p = lanes_problem
    with pytest.raises(ValueError):
        make_logpost_lanes(_spec(), p["xs"][0], p["ys"][0], 1.0)
    with pytest.raises(ValueError):
        make_logpost_lanes(_spec(), p["xs"], p["ys"][:, :5], 1.0)


def test_laplace_lanes_is_the_serial_fit(lanes_problem):
    from ccgp_tpu_torch.infer.laplace import laplace

    p = lanes_problem
    for i in range(3):
        ref = laplace(lambda z: p["serial"][i](z).val, p["starts"][i])
        assert _rel(p["fits"].mode[i], ref.mode) < 1e-12
        assert _rel(p["fits"].cov[i], ref.cov) < 1e-10


def _same_chain(lanes, i, ref, exact=False):
    lane = lanes.lane(i)
    for f in ("n_recorded", "n_proposals", "n_accepted", "n_rounds",
              "converged"):
        assert getattr(lane, f) == getattr(ref, f), f
    assert abs(lane.pvalue - ref.pvalue) < 1e-10
    k = ref.n_recorded
    np.testing.assert_allclose(lane.samples[:k].numpy(),
                               ref.samples[:k].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lane.logposts[:k].numpy(),
                               ref.logposts[:k].numpy(), rtol=1e-10)
    np.testing.assert_allclose(lane.betas[:k].numpy(), ref.betas[:k].numpy(),
                               rtol=1e-10, atol=1e-10)
    assert torch.all(torch.isinf(lane.logposts[k:]))


@pytest.mark.parametrize("record", ["accepted", "all"])
def test_metropolis_lanes_is_the_serial_chain_per_lane(lanes_problem,
                                                       record):
    p = lanes_problem
    run = dict(n_max=300, samp_size=100, record=record)
    res = metropolis_lanes(p["lp"], p["starts"], p["keys"], **run)
    assert res.samples.shape == (3, 300, 3)
    for i in range(3):
        ref = metropolis(p["serial"][i], p["starts"][i], p["keys"][i], **run)
        _same_chain(res, i, ref)
        assert _rel(res.laplace.mode[i], ref.laplace.mode) < 1e-12
    # the vectorized retained window is each lane's own
    zs, betas, _ = res.retained(100)
    for i in range(3):
        z1, b1, _ = res.lane(i).retained(100)
        assert torch.equal(zs[i], z1) and torch.equal(betas[i], b1)
    np.testing.assert_array_equal(
        res.chain_ok(100), [res.lane(i).chain_ok(100) for i in range(3)])


def test_metropolis_lanes_freezes_a_capped_lane(lanes_problem, monkeypatch):
    """max_proposals stops every lane at 137 proposals and n_max the
    fastest recorders earlier: each lane stops at its own round."""
    p = lanes_problem
    run = dict(n_max=40, samp_size=20, max_proposals=137,
               laplace_fit=None)
    from ccgp_tpu_torch.infer import metropolis as metro_mod

    monkeypatch.setattr(metro_mod, "LANES_DRAW_ROUNDS", 16)
    res = metropolis_lanes(p["lp"], p["fits"].mode, p["keys"], n_max=40,
                           samp_size=20, max_proposals=137,
                           laplace_fits=p["fits"])
    assert len(set(res.n_proposals.tolist())) > 1 or len(
        set(res.n_recorded.tolist())) > 1
    for i in range(3):
        fit = LaplaceFit(*(f[i] for f in p["fits"]))
        ref = metropolis(p["serial"][i], p["fits"].mode[i], p["keys"][i],
                         **{**run, "laplace_fit": fit})
        _same_chain(res, i, ref)


def test_metropolis_lanes_on_one_shared_logpost(lanes_problem):
    """Without `lane`, one batch-capable log-posterior serves every lane
    (the multi-chain case): lane i is metropolis(lp, starts[i], keys[i])."""
    p = lanes_problem
    lp = p["serial"][0]
    starts = torch.tensor([[1.0, 1.0, 0.0], [0.5, 2.0, 0.3]],
                          dtype=torch.float64)
    keys = p["keys"][:2]
    res = metropolis_lanes(lp, starts, keys, n_max=120, samp_size=40)
    for i in range(2):
        _same_chain(res, i, metropolis(lp, starts[i], keys[i], n_max=120,
                                       samp_size=40))


# ---------------------------------------------------------------------------
# the sweep against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_root(tmp_path_factory):
    return chip_smoke.standin_data_root(tmp_path_factory.mktemp("sweep"))


@pytest.fixture
def at_root(monkeypatch, sweep_root):
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "_DEFAULT_ROOTS", (str(sweep_root),))
    return sweep_root


def test_standin_designs_load_as_the_reference_files(at_root):
    d = chip_smoke.sweep_standin_designs()
    assert d.shape == (100, 14, 2)
    for i in (1, 50, 100):
        got = tdata.load_2d_training_design(i)
        np.testing.assert_array_equal(got, d[i - 1])
        np.testing.assert_array_equal(jdata.load_2d_training_design(i), got)
    # Latin hypercubes: one point in each of the 14 bins per axis
    for dsg in d[:5]:
        for a in range(2):
            assert sorted(np.floor(dsg[:, a] * 14).astype(int)) == list(
                range(14))


@pytest.fixture(scope="module")
def jax_sweep(sweep_root):
    import pytest as _pt

    with _pt.MonkeyPatch.context() as mp:
        mp.setattr(jdata, "_DEFAULT_ROOTS", (str(sweep_root),))
        cfg = jsweep.Config(n_designs=3, n_new_axis=5,
                            mcmc=JMCMC(**SWEEP_MCMC))
        return jsweep.run(cfg, key=jax.random.PRNGKey(0), dtype=jnp.float64)


def _port_sweep(**over):
    cfg = tsweep.Config(n_designs=3, n_new_axis=5,
                        mcmc=MCMCConfig(**SWEEP_MCMC), **over)
    stages = {}
    out = tsweep.run(cfg, key=rng.PRNGKey(0, device="cpu"),
                     dtype=torch.float64, device="cpu",
                     stages=None if over else stages)
    return out, stages


def test_sweep_matches_jax(at_root, jax_sweep):
    out, stages = _port_sweep()
    for f in ("rmspe", "coverage", "quant"):
        got, ref = getattr(out, f), getattr(jax_sweep, f)
        assert got.shape == (3,)
        assert _rel(got, ref) < 1e-8, f
    np.testing.assert_array_equal(out.chain_ok, np.asarray(jax_sweep.chain_ok))
    assert {"plug-in", "laplace", "rounds", "predict"} <= set(stages)
    assert stages["chains"].n_recorded.shape == (3,)


def test_sweep_plugin_sigma2_matches_jax(at_root):
    """The 32-point grid plug-in per design against JAX's (the sweep's
    `study_one` prologue) within 1e-12 relative."""
    from ccgp_tpu.eval.functions import test_function_2d as jf2
    from ccgp_tpu.ops import kernels as jk, linalg as jl
    from ccgp_tpu.ops.gp import gls_beta, profile_nll, sigma2_mle

    d = chip_smoke.sweep_standin_designs(3)
    xs = torch.tensor(d)
    ys = torch.stack([torch.tensor(np.asarray(jf2(jnp.asarray(x), 2)))
                      for x in d])
    got = tsweep.plugin_sigma2(xs, ys, 1e-5)
    fam = jk.sqexp_family()
    mg = jnp.asarray(tsweep.MLE_GRID)
    for i, x in enumerate(d):
        x, y = jnp.asarray(x), jnp.asarray(ys[i].numpy())
        nlls = jax.vmap(lambda lt: profile_nll(
            jl.jitter_cholesky(fam.gram(x, jnp.exp(lt)), 1e-5), y))(mg)
        nlls = jnp.where(jnp.isfinite(nlls), nlls, jnp.inf)
        ch = jl.jitter_cholesky(fam.gram(x, jnp.exp(mg[jnp.argmin(nlls)])),
                                1e-5)
        assert _rel(got[i], sigma2_mle(ch, y, gls_beta(ch, y))) < 1e-12


def test_sweep_on_a_two_device_mesh_is_the_sweep(at_root, jax_sweep):
    out, _ = _port_sweep(mesh_devices=2)
    for f in ("rmspe", "coverage", "quant"):
        assert _rel(getattr(out, f), getattr(jax_sweep, f)) < 1e-8, f
    np.testing.assert_array_equal(out.chain_ok, np.asarray(jax_sweep.chain_ok))


def test_cli_sweep_prints_the_jax_lines(at_root, capsys):
    argv = ["sim_2d_sweep", "--cpu", "--f64", "--fast", "--designs", "3"]
    assert tcli.main(argv) == 0
    port = capsys.readouterr().out.splitlines()
    assert jcli.main(argv) == 0
    ref = capsys.readouterr().out.splitlines()
    assert port == ref and len(port) == 3
    assert port[0] == "sweep over 3 designs (mesh=1 device(s)):"
    assert tcli.main(argv + ["--mesh", "2"]) == 0
    meshed = capsys.readouterr().out.splitlines()
    assert meshed[0] == "sweep over 3 designs (mesh=2 device(s)):"
    assert meshed[1:] == port[1:]


def test_cli_mesh_without_enough_cuda_devices_raises(at_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA device.* 1 present"):
        tcli.main(["sim_2d_sweep", "--mesh", "2", "--designs", "3"])
