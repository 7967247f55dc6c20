"""`run_study` through `sim_1d` (the random LHS, the kriging plug-in and
the reference single-GP baseline, the Matern combined GP with the K = 1
sampler, the composite GP in 1-D, Quant against the truth) on the CPU,
float64, against the JAX package at a small MCMC budget. Tolerances as in
tests/test_torch_study.py.
"""
import jax
import numpy as np

from ccgp_tpu.experiments import sim_1d as jsim_1d
from ccgp_tpu.models import MCMCConfig as JCfg
from ccgp_tpu_torch.experiments import sim_1d
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.ops import rng

ONE_D = dict(start=(0.0, 1.5, 0.0), n_max=240, samp_size=80,
             net_samp_size=60)
TOL = 1e-7


def close(got, ref):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= TOL, float(err.max())


def compare(jres, tres):
    """The chain counters equal; every model's predictions, the summary
    and the ESS within TOL."""
    jm, tm = jres.fit.mcmc, tres.fit.mcmc
    assert (tm.n_recorded, tm.n_proposals) == (int(jm.n_recorded),
                                               int(jm.n_proposals))
    assert tres.fit.chain_ok == bool(jres.fit.chain_ok)
    assert set(tres.predictions) == set(jres.predictions)
    for name, jp in jres.predictions.items():
        for f in ("mean", "lower", "upper", "quant"):
            if getattr(jp, f) is not None:
                close(getattr(tres.predictions[name], f), getattr(jp, f))
    js, ts = jres.summary, tres.summary
    for name in js.rmspe:
        close(ts.rmspe[name], js.rmspe[name])
        close(ts.coverage[name], js.coverage[name])
    close(ts.average_quantile, js.average_quantile)
    close(tres.min_ess, jres.min_ess)


def test_sim_1d_matches_jax():
    jcfg = jsim_1d.Config(func=2, mcmc=JCfg(**ONE_D), n_new=20)
    tcfg = sim_1d.Config(func=2, mcmc=MCMCConfig(**ONE_D), n_new=20)
    jres = jsim_1d.run(jcfg, key=jax.random.PRNGKey(1))
    tres = sim_1d.run(tcfg, key=rng.PRNGKey(1, device="cpu"), device="cpu")
    compare(jres, tres)
