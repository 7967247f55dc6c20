"""The study cell (`gv9d.study`): the plain reference of its baselines and
table (`reference/study.py`) against the port's CPU path on seeded random
data; the reference's imports; `correct` true for the program and false
under each planted fault of `faults/study.py` and under the float32
control, on the CPU at a cut chain budget; and on the
card one study request through the harness against the reference."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import check, spec
from harness.cell import run
from harness.readings import readings
from reference import combined_gp as ref
from reference import study as rs

BENCH_DIR = Path(__file__).resolve().parent.parent
CELL = "gv9d.study"
SEED = 2 ** 31 + 3


def rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((torch.abs(got - want)
                  / torch.clamp_min(torch.abs(want), 1.0)).max())


@pytest.fixture(scope="module")
def port():
    """The port's baselines on the CPU at n = 12, d = 3, float64."""
    from ccgp_tpu_torch.eval.compare import (ModelPrediction,
                                             comparison_summary)
    from ccgp_tpu_torch.infer.mle import mlegp_fit
    from ccgp_tpu_torch.models import composite_gp as cg
    from ccgp_tpu_torch.models.kriging import kriging_predict
    from ccgp_tpu_torch.ops import kernels, rng

    g = torch.Generator().manual_seed(11)
    x = torch.rand(12, 3, generator=g, dtype=torch.float64)
    y = (torch.sin(3 * x).sum(-1)
         + 0.1 * torch.randn(12, generator=g, dtype=torch.float64))
    x_new = torch.rand(20, 3, generator=g, dtype=torch.float64)
    y_new = torch.sin(3 * x_new).sum(-1)
    fam = kernels.sqexp_family()
    key = rng.PRNGKey(5, device="cpu")
    kf = mlegp_fit(fam, x, y, key, jitter=0.0)
    kp = kriging_predict(fam, x, y, kf, x_new, alpha=0.05, variant="mlegp")
    cf = cg.cgp_fit(x, y, key, n_candidates=40)
    cp = cg.cgp_predict(cf, x_new)
    preds = {"single": ModelPrediction(kp.mean.numpy(), kp.lower.numpy(),
                                       kp.upper.numpy()),
             "cgp": ModelPrediction(cp.mean.numpy(), cp.lower.numpy(),
                                    cp.upper.numpy())}
    return dict(x=x, y=y, x_new=x_new, y_new=y_new, kf=kf, kp=kp, cf=cf,
                cp=cp, key=key, preds=preds,
                summary=comparison_summary(y_new.numpy(), preds),
                x_std=cg._standardize(x)[0])


def test_ard_nll_and_fit(port):
    lt = torch.log(port["kf"].theta)
    assert rel(port["kf"].nll, rs.ard_nll(port["x"], port["y"],
                                          lt[None])[0]) < 1e-10
    fit = ref.plugin(port["x"], port["y"], port["kf"].theta, 0.0)
    assert rel(port["kf"].sigma2, fit["sigma2"]) < 1e-10
    assert rel(port["kf"].beta, fit["beta"]) < 1e-10


def test_mlegp_predictor(port):
    want = rs.ard_predict(port["x"], port["y"], torch.log(port["kf"].theta),
                          port["x_new"], 0.05)
    for k in ("mean", "lower", "upper"):
        assert rel(getattr(port["kp"], k), want[k]) < 1e-10


def test_cgp_objective_and_local_variances(port):
    from ccgp_tpu_torch.models import composite_gp as cg

    cf = port["cf"]
    w = rs.cgp_w(port["x"], cf.theta, cf.alpha, cf.lam, cf.bandwidth)
    assert rel(cf.objval, rs.cgp_objective(port["x_std"], port["y"],
                                           w[None])[0]) < 1e-10
    # more points of w, the port's objective as one batch
    lo, hi = rs.cgp_box(port["x_std"])
    g = torch.Generator().manual_seed(2)
    ws = lo + (hi - lo) * torch.rand(16, lo.shape[0], generator=g,
                                     dtype=torch.float64)
    assert rel(cg._objective(ws, port["x_std"], port["y"]),
               rs.cgp_objective(port["x_std"], port["y"], ws)) < 1e-10
    st = rs.cgp_state(port["x"], port["y"], cf.theta, cf.alpha, cf.lam,
                      cf.bandwidth)
    assert rel(cf.sig, st["s"]) < 1e-10
    assert rel(cf.tau2, st["tau2"]) < 1e-10


def test_cgp_jackknife(port):
    cf = port["cf"]
    assert rel(cf.rmscv, rs.cgp_jackknife(port["x"], port["y"], cf.theta,
                                          cf.alpha, cf.lam,
                                          cf.bandwidth)) < 1e-10


def test_cgp_predictor(port):
    cf = port["cf"]
    want = rs.cgp_predict(port["x"], port["y"], cf.theta, cf.alpha, cf.lam,
                          cf.bandwidth, port["x_new"])
    for k in ("mean", "lower", "upper"):
        assert rel(getattr(port["cp"], k), want[k]) < 1e-10


def test_summary(port):
    want = rs.summary(port["y_new"], {k: p._asdict() for k, p in
                                      port["preds"].items()})
    got = port["summary"]
    for name in port["preds"]:
        assert abs(got.rmspe[name] - want["rmspe"][name]) <= (
            1e-10 * want["rmspe"][name])
        assert got.coverage[name] == want["coverage"][name]


def test_t_quantile():
    import scipy.stats

    for df in (5, 11, 49):
        assert abs(rs.t_quantile(0.975, df)
                   - scipy.stats.t.ppf(0.975, df)) < 1e-10


def test_descents_reach_the_port_optimum(port):
    """From a start off the optimum the reference's descents reach at
    least the port's fitted value."""
    x, y, kf, cf = port["x"], port["y"], port["kf"], port["cf"]
    lt = torch.log(kf.theta)
    _, f = rs.ard_descend(x, y, (lt + 1.0)[None], (-14.0, 14.0))
    assert float(f[0]) <= float(kf.nll) + 1e-6
    w = rs.cgp_w(x, cf.theta, cf.alpha, cf.lam, cf.bandwidth)
    _, f = rs.cgp_descend(x, y, w[None])
    assert float(f[0]) <= float(cf.objval) + 1e-9


def test_reference_imports_no_program():
    tree = ast.parse((BENCH_DIR / "reference" / "study.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch", "reference"}, names


def _small():
    """The cell at a cut chain budget: one checked request, the rest at
    the cell's size."""
    cell = spec.load_cell(CELL)
    cell.config.update(n_max=2000, samp_size=150, net_samp_size=150)
    cell.traffic["check"] = dict(requests=1)
    return cell


def _correct(cell, seed=SEED):
    res = run(cell, seed, 0.5, False, "cpu")
    assert res["failed"] == 0
    return check.judge(res["numbers"], cell.limits)


def test_program_is_correct():
    ok, checks = _correct(_small())
    assert ok, checks


# the number each fault has to move past its limit
CAUGHT_BY = {"mlegp_first_start": "mlegp_best",
             "cgp_one_iteration": "cgp_obj",
             "cgp_unrefined": "cgp_opt",
             "jackknife_wrong_point": "cgp_rmscv",
             "laplace_at_start": "laplace_mode",
             "lenient_accept": "accept",
             "geweke_early": "geweke"}


def test_every_fault_is_named():
    assert set(CAUGHT_BY) == set(spec.load_module("faults",
                                                  "study").FAULTS)


@pytest.mark.parametrize("fault", sorted(CAUGHT_BY))
def test_fault_is_not_correct(fault):
    cell = _small()
    plant = spec.load_module("faults", "study").plant
    with plant(fault):
        ok, checks = _correct(cell)
    assert not ok, checks
    c = checks[CAUGHT_BY[fault]]
    assert c["value"] is not None and c["value"] > c["limit"], checks


def test_control_is_not_correct():
    cell = _small()
    r = readings(cell, 12, "cpu", True)
    ok_program, _ = check.judge(r["program"], cell.limits)
    ok_control, checks = check.judge(r["control"], cell.limits)
    assert ok_program
    assert not ok_control, checks


@pytest.mark.card
def test_one_study_request_on_the_card(card):
    """One study at the cell's own size through the harness, judged
    against the reference with the cell's limits."""
    cell = spec.load_cell(CELL)
    cell.traffic["check"] = dict(requests=1)
    res = run(cell, SEED, 1.0, False, "cuda")
    assert res["failed"] == 0
    ok, checks = check.judge(res["numbers"], cell.limits)
    assert ok, checks
    assert np.isfinite(res["memory_peak_bytes"])
