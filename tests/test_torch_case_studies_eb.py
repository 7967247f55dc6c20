"""The two data-file studies with an empirical-Bayes hyperprior scan, on
the CPU, float64, against the JAX package: `heat_exchanger` (both paths)
and `sim_2d_iso_advanced` (both compat modes) on stand-ins for the
reference's files (`chip_smoke.standin_data_root`: the Qian sets, the
heat grid cut to 6 of its 624 rows, the 14-point design, the 60-row 2-D
grid), read by both packages under one temporary data root; and the heat
scan's likelihood per row. The helpers, the --fast budget and the
tolerances are tests/test_torch_case_studies.py's: every study here takes
its plug-in sigma^2 from `mlegp_fit`, so PLUGIN_TOL (1e-7); the scan at a
given sigma^2 within 1e-9.
"""
import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from ccgp_tpu.eb import choose_hyperpars as jchoose
from ccgp_tpu.experiments import heat_exchanger as jheat
from ccgp_tpu.experiments import sim_2d_iso_advanced as jadv
from ccgp_tpu.models import MixtureSpec as JSpec
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch.eb import choose_hyperpars
from ccgp_tpu_torch.eval import datasets as tdata
from ccgp_tpu_torch.experiments import heat_exchanger as theat
from ccgp_tpu_torch.experiments import sim_2d_iso_advanced as tadv
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.ops import kernels as tkern, rng
from test_torch_case_studies import (  # noqa: F401 (at_root: a fixture)
    PLUGIN_TOL, at_root, close, compare, mcmc)


@pytest.fixture(scope="module")
def standin_root(tmp_path_factory):
    return chip_smoke.standin_data_root(tmp_path_factory.mktemp("standin"),
                                        heat_rows=range(0, 624, 104))


@pytest.mark.parametrize("eb_search", [False, True])
def test_heat_exchanger_matches_jax(standin_root, at_root, eb_search):
    at_root(standin_root)
    jm, tm = mcmc(4, start=(1.0, 2.7, 0.0))
    small = dict(eb_search=eb_search, n_nodes=256)
    jres = jheat.run(jheat.Config(mcmc=jm, **small),
                     key=jax.random.PRNGKey(0))
    tres = theat.run(theat.Config(mcmc=tm, **small),
                     key=rng.PRNGKey(0, device="cpu"), device="cpu")
    compare(jres, tres, PLUGIN_TOL)


@pytest.mark.parametrize("compat", ["fixed", "reference"])
def test_sim_2d_iso_advanced_matches_jax(standin_root, at_root, compat):
    at_root(standin_root)
    jm, tm = mcmc(4)
    jres = jadv.run(jadv.Config(mcmc=jm, compat=compat),
                    key=jax.random.PRNGKey(0))
    tres = tadv.run(tadv.Config(mcmc=tm, compat=compat),
                    key=rng.PRNGKey(0, device="cpu"), device="cpu")
    compare(jres, tres, PLUGIN_TOL)


def test_eb_choice_matches_jax(standin_root):
    """The heat scan alone: its log-likelihood per grid row, and its
    argmax, at a given sigma^2."""
    q = tdata.load_qian(root=standin_root)
    grid = tdata.load_hyperpars_grid("heat", root=standin_root)
    assert grid.shape == (6, 4)
    spec = TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=4)
    got = choose_hyperpars(spec, q["x_train"], q["y_train"], grid, 30.0,
                           n_nodes=256, tau=50.0, device="cpu")
    ref = jchoose(JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=4),
                  jnp.asarray(q["x_train"]), jnp.asarray(q["y_train"]),
                  jnp.asarray(grid), 30.0, n_nodes=256, tau=50.0)
    close(got.likelihoods, ref.likelihoods, 1e-9)
    assert int(got.index) == int(ref.index)
