"""`experiments.common.run_study` under the port's tracer: a study is one
`study` record with the combined GP's `fit` and `predict`, mlegp's
`mlegp` (counting its starts), the single GP's `single`, the composite
GP's `cgp` (its candidates, searches and jackknife) and `cgp_predict`
below it; the result carries the fits the baselines predicted from; and
the study is bit-identical at trace levels 0 and 1. A small CPU study:
n = 12, d = 2, a short chain, 24 composite-GP candidates."""
import numpy as np
import pytest
import torch

from ccgp_tpu_torch.experiments.common import run_study
from ccgp_tpu_torch.infer.mle import mlegp_fit
from ccgp_tpu_torch.models.combination import MixtureSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.composite_gp import cgp_fit
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels, rng
from ccgp_tpu_torch.utils import trace

N, D, CANDIDATES = 12, 2, 24
MCMC = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=600, samp_size=100,
                  net_samp_size=100, speculative=4)
MLEGP_STARTS = 1 + 4 * D + 12


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(7)
    x = torch.tensor(r.uniform(size=(N, D)))
    y = torch.sin(4 * x[:, 0]) + torch.cos(3 * x[:, 1])
    x_new = torch.tensor(r.uniform(size=(15, D)))
    y_new = torch.sin(4 * x_new[:, 0]) + torch.cos(3 * x_new[:, 1])
    return x, y, x_new, y_new.numpy()


def study(data):
    x, y, x_new, y_new = data
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=D)
    return run_study(spec, x, y, x_new, y_new, rng.PRNGKey(3, device="cpu"),
                     MCMC, theta1_prior=InverseGamma(3, 1),
                     theta2_prior=InverseGamma(5, 75), mle_ard=True,
                     cgp_candidates=CANDIDATES, on_unconverged="ignore",
                     single_variant="mlegp", device="cpu")


@pytest.fixture(scope="module")
def runs(data):
    """The study at levels 0 and 1, and the records each left."""
    out = {}
    try:
        for level in (0, 1):
            trace.set_level(level)
            trace.clear()
            out[level] = (study(data), trace.requests())
    finally:
        trace.set_level(1)
        trace.clear()
    return out


def test_one_study_record_per_call(runs):
    assert runs[0][1] == []
    recs = runs[1][1]
    assert [r["name"] for r in recs] == ["study"]
    assert not recs[0]["raised"]


def test_spans_and_counters(runs):
    rec = runs[1][1][0]
    paths = set(rec["spans"])
    assert {"mlegp", "mlegp/plugin", "mlegp/bfgs", "fit", "fit/plugin",
            "fit/laplace", "fit/sampler", "predict", "single", "cgp",
            "cgp/candidates", "cgp/bfgs", "cgp/jackknife",
            "cgp_predict"} <= paths
    assert not any(p.startswith(("single/", "cgp_predict/")) for p in paths)
    assert rec["spans"]["mlegp/bfgs"][0] == MLEGP_STARTS
    c = rec["counts"]
    assert c["mlegp"]["mlegp.starts"] == MLEGP_STARTS
    assert c["cgp/candidates"]["cgp.candidates"] == CANDIDATES
    assert c["cgp/jackknife"]["cgp.jackknife_refits"] == N
    assert c["mlegp/bfgs"]["bfgs.evals"] >= MLEGP_STARTS
    assert c["cgp/bfgs"]["bfgs.evals"] >= 5
    children = sum(rec["spans"][p][1] for p in paths if "/" not in p)
    assert rec["child_ns"] == children <= rec["ns"]


def test_result_carries_the_baselines_fits(runs, data):
    res = runs[1][0]
    x, y, _, _ = data
    _, _, k_cgp, k_single = rng.split(rng.PRNGKey(3, device="cpu"), 4)
    kf = mlegp_fit(kernels.sqexp_family(), x, y, k_single, jitter=0.0)
    cf = cgp_fit(x, y, k_cgp, n_candidates=CANDIDATES)
    for a, b in zip(res.single_fit, kf):
        assert torch.equal(a, b)
    for a, b in zip(res.cgp_fit, cf):
        assert torch.equal(a, b)
    assert torch.equal(res.fit.sigma2, kf.sigma2)


def test_bit_identical_at_levels_0_and_1(runs):
    a, b = runs[0][0], runs[1][0]
    assert a.summary == b.summary
    for name in a.predictions:
        for u, v in zip(a.predictions[name], b.predictions[name]):
            assert (u is None and v is None) or np.array_equal(u, v)
    for u, v in ((a.fit.zs, b.fit.zs), (a.fit.mcmc.samples,
                                        b.fit.mcmc.samples)):
        assert torch.equal(u, v)
    for fa, fb in ((a.single_fit, b.single_fit), (a.cgp_fit, b.cgp_fit)):
        for u, v in zip(fa, fb):
            assert torch.equal(u, v)
