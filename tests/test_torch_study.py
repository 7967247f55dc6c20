"""The study path end to end on the CPU, float64, against the JAX package:
`run_study` through `sim_2d_iso` (the design, the mlegp plug-in and
baseline, the combined GP, the composite GP, the summary) and the CLI
`python -m ccgp_tpu_torch`; `sim_1d` in tests/test_torch_study_1d.py (a
file of its own, so that the two JAX compiles run in two workers).

Tolerances: chain counters equal; the predictions of all three models and
the summary's RMSPE, coverage and calibration quantile 1e-7 relative to
max(1, |value|). The plug-in sigma^2 carries the BFGS stopping point of
`mlegp_fit` / `kriging_mle` (~1e-8 relative, see test_torch_baselines.py)
into every draw, and the composite GP's optimum its own; every decision of
the chain is the same, so the summaries carry that roundoff only (and a
coverage, a fraction of test points, is equal unless a bound moves across
the truth by that much).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.experiments import sim_2d_iso as jsim_2d_iso
from ccgp_tpu.models import MCMCConfig as JCfg
from ccgp_tpu_torch.__main__ import main
from ccgp_tpu_torch.experiments import sim_2d_iso
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.ops import rng

ISO = dict(start=(1.0, 1.0, 0.0), n_max=1200, samp_size=300,
           net_samp_size=200)          # tests/test_experiments.py's FAST
TOL = 1e-7


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def compare(jres, tres):
    jm, tm = jres.fit.mcmc, tres.fit.mcmc
    assert tm.n_recorded == int(jm.n_recorded)
    assert tm.n_proposals == int(jm.n_proposals)
    assert tres.fit.chain_ok == bool(jres.fit.chain_ok)
    assert set(tres.predictions) == set(jres.predictions)
    for name, jp in jres.predictions.items():
        tp = tres.predictions[name]
        for f in ("mean", "lower", "upper", "quant"):
            if getattr(jp, f) is not None:
                close(getattr(tp, f), getattr(jp, f))
    js, ts = jres.summary, tres.summary
    for name in js.rmspe:
        close(ts.rmspe[name], js.rmspe[name])
        close(ts.coverage[name], js.coverage[name])
    close(ts.average_quantile, js.average_quantile)
    close(tres.min_ess, jres.min_ess)


def test_sim_2d_iso_matches_jax():
    jcfg = jsim_2d_iso.Config(func=3, mcmc=JCfg(**ISO), n_new_axis=7)
    tcfg = sim_2d_iso.Config(func=3, mcmc=MCMCConfig(**ISO), n_new_axis=7)
    jres = jsim_2d_iso.run(jcfg)
    tres = sim_2d_iso.run(tcfg, key=rng.PRNGKey(0, device="cpu"),
                          device="cpu")
    compare(jres, tres)
    assert tres.summary.rmspe["combined"] < 1.0


def test_cli_prints_the_three_lines(capsys):
    assert main(["sim_2d_iso", "--fast", "--cpu", "--f64"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("RMSPE:") and "combined" in out[0]
    assert out[1].startswith("coverage:") and "cgp" in out[1]
    assert out[2].startswith("calibration quantile:")


@pytest.mark.parametrize("name", ["no_such_study"])
def test_cli_refuses_what_is_not_ported(name, capsys):
    assert main([name, "--cpu"]) != 0
    assert "ROADMAP" in capsys.readouterr().err


def test_design_matches_jax():
    """The experiments' designs: maximin_lhs(split(PRNGKey(0))[0])."""
    k_d = jax.random.split(jax.random.PRNGKey(0))[0]
    from ccgp_tpu.design.lhs import maximin_lhs as jmaximin
    from ccgp_tpu_torch.design.lhs import maximin_lhs

    ref = np.asarray(jmaximin(k_d, 14, 2, dtype=jnp.float64))
    got = maximin_lhs(rng.split(rng.PRNGKey(0, device="cpu"))[0], 14, 2)
    assert np.array_equal(got.numpy(), ref)
    assert torch.all((got > 0) & (got < 1))
