"""The data-file case studies on the CPU, float64, against the JAX package:
`ground_vibrations` on the GV data rebuilt from the repo's tables
(`chip_smoke.gv_data_root`) and held to R's archived mlegp fit,
`run_study`'s options, and the CLI; `heat_exchanger` and
`sim_2d_iso_advanced` on stand-ins for the reference's files are in
tests/test_torch_case_studies_eb.py (a file of its own, so that the JAX
compiles run in two workers).

Both packages read the same files under a temporary data root. The
studies are kept small through their own parameters: the CLI's --fast
MCMC budget as the Config's mcmc, the composite GP in one GV run only,
and for the heat exchanger's empirical-Bayes scan a grid of a few rows
and a few hundred nodes. JAX on the CPU takes its one-round sampler, the
port its chunked driver; the two are law-equal, so the chain counters are
equal.

Tolerances: the single GP at the archived rates reproduces R's columns
within 1e-6 (absolute, as `tests/test_kriging_eval.py` holds JAX);
chain counters equal; draws, predictions and summaries within 1e-8
relative to max(1, |value|) where the plug-in sigma^2 is given (a value,
or a fit such as the archived one), and within 1e-7 where a BFGS fit
(`mlegp_fit`, `kriging_mle`) makes it: each package's BFGS stops where
the gradient falls below its tolerance, ~1e-8 relative apart (up to
3.3e-8 on the heat stand-in), and every draw inherits that, as
tests/test_torch_study.py allows.
"""
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ccgp_tpu import __main__ as jcli
from ccgp_tpu.eval import datasets as jdata
from ccgp_tpu.experiments import common as jcommon
from ccgp_tpu.experiments import ground_vibrations as jgv
from ccgp_tpu.infer.mle import KrigingMLE as JMLE
from ccgp_tpu.models import InverseGamma as JIG
from ccgp_tpu.models import MCMCConfig as JCfg, MixtureSpec as JSpec
from ccgp_tpu.ops import kernels as jkern
from ccgp_tpu_torch import __main__ as tcli
from ccgp_tpu_torch.eval import datasets as tdata
from ccgp_tpu_torch.eval import results as tresults
from ccgp_tpu_torch.experiments import common as tcommon
from ccgp_tpu_torch.experiments import ground_vibrations as tgv
from ccgp_tpu_torch.infer.mle import KrigingMLE as TMLE
from ccgp_tpu_torch.models.combination import MixtureSpec as TSpec
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.models.kriging import kriging_predict
from ccgp_tpu_torch.models.priors import InverseGamma
from ccgp_tpu_torch.ops import kernels as tkern, linalg, rng
from ccgp_tpu_torch.ops.gp import gls_beta, sigma2_mle

ROOT = Path(__file__).resolve().parent.parent
FAST = dict(n_max=1200, samp_size=300, net_samp_size=200)   # the CLI's --fast
TOL = 1e-8
PLUGIN_TOL = 1e-7   # a BFGS plug-in (module docstring)


def close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def compare(jres, tres, tol=TOL):
    jm, tm = jres.fit.mcmc, tres.fit.mcmc
    assert tm.n_recorded == int(jm.n_recorded)
    assert tm.n_proposals == int(jm.n_proposals)
    assert tm.converged == bool(jm.converged)
    assert tres.fit.chain_ok == bool(jres.fit.chain_ok)
    close(tres.fit.sigma2, jres.fit.sigma2, tol)
    close(tres.fit.zs, jres.fit.zs, tol)
    assert set(tres.predictions) == set(jres.predictions)
    for name, jp in jres.predictions.items():
        tp = tres.predictions[name]
        for f in ("mean", "lower", "upper", "quant"):
            assert (getattr(tp, f) is None) == (getattr(jp, f) is None)
            if getattr(jp, f) is not None:
                close(getattr(tp, f), getattr(jp, f), tol)
    js, ts = jres.summary, tres.summary
    for name in js.rmspe:
        close(ts.rmspe[name], js.rmspe[name], tol)
        close(ts.coverage[name], js.coverage[name], tol)
    close(ts.average_quantile, js.average_quantile, tol)


@pytest.fixture
def at_root(monkeypatch):
    """Point both packages' loaders at a data root."""
    def point(root):
        for mod in (tdata, jdata):
            monkeypatch.setattr(mod, "_DEFAULT_ROOTS", (str(root),))
    return point


@pytest.fixture(scope="module")
def gv_root(tmp_path_factory):
    return chip_smoke.gv_data_root(tmp_path_factory.mktemp("gv"))


def mcmc(speculative=0, start=(1.0, 1.0, 0.0)):
    kw = dict(start=start, speculative=speculative, **FAST)
    return JCfg(**kw), MCMCConfig(**kw)


# ---------------------------------------------------------------------------
# the ground-vibrations data and R's archived fit
# ---------------------------------------------------------------------------

def table(i):
    cols, tab = tresults.read_comparison_table(
        ROOT / "results" / f"GV Size 50 Results {i}.txt")
    return (tab[:, [cols.index(c) for c in chip_smoke.GV_INPUTS]],
            tab[:, cols.index("y.true")])


def test_gv_data_root_rebuilds_the_200_points(gv_root):
    points = set()
    for i in range(1, 10):
        gv = tdata.load_ground_vibrations(50, i, root=gv_root)
        jgv_ = jdata.load_ground_vibrations(50, i, root=gv_root)
        for k in gv:
            assert np.array_equal(gv[k], jgv_[k])
        assert gv["x_train"].shape == (50, 9) and gv["x_test"].shape == (150, 9)
        x, y = table(i)
        assert np.array_equal(gv["x_test"], x) and np.array_equal(
            gv["y_test"], y)
        train = {tuple(r) for r in np.column_stack([gv["x_train"],
                                                    gv["y_train"]])}
        test = {tuple(r) for r in np.column_stack([x, y])}
        assert len(train) == 50 and len(test) == 150 and not train & test
        points |= train | test
    assert len(points) == 200


def test_gv_data_root_refuses_missing_points(tmp_path, monkeypatch):
    read = tresults.read_comparison_table

    def drop_last(path):     # every table loses its last row
        cols, tab = read(path)
        return cols, tab[:-1]

    monkeypatch.setattr(tresults, "read_comparison_table", drop_last)
    with pytest.raises(AssertionError, match="distinct points"):
        chip_smoke.gv_data_root(tmp_path)


def test_archived_fit_reproduces_r_single_columns(gv_root):
    """The port's counterpart of `tests/test_kriging_eval.py::
    test_mlegp_archived_table_reproduction`, on the rebuilt split: at
    mlegp's recovered rates the mlegp-variant kriging predictor gives R's
    archived `y.hat.single` / `LL.single` / `UL.single` columns."""
    gv = tdata.load_ground_vibrations(50, 1, root=gv_root)
    x, y, xt = (torch.tensor(gv[k]) for k in ("x_train", "y_train", "x_test"))
    fit = tgv.archived_mlegp_fit(x, y)
    pred = kriging_predict(tkern.sqexp_family(), x, y, fit, xt, alpha=0.05,
                           variant="mlegp")
    cols, tab = tresults.read_comparison_table(
        ROOT / "results_compat_mlegp" / "GV Size 50 Results 1.txt")
    assert np.array_equal(tab[:, cols.index("y.true")], gv["y_test"])
    for f, c in (("mean", "y.hat.single"), ("lower", "LL.single"),
                 ("upper", "UL.single")):
        assert float(np.max(np.abs(getattr(pred, f).numpy()
                                   - tab[:, cols.index(c)]))) < 1e-6
    assert np.isclose(float(fit.beta), 3.9059508390545363, atol=1e-6)
    assert np.isclose(float(fit.sigma2), 10.249401335560487, rtol=1e-6)
    # the Gram at these rates is ill-conditioned (one rate is e^12.7), so
    # the two packages' factors part by ~4e-10 in their last digits
    jfit = jgv.archived_mlegp_fit(jnp.asarray(gv["x_train"]),
                                  jnp.asarray(gv["y_train"]))
    for got, ref in zip(fit, jfit):
        close(got, ref, 1e-8)


def test_archived_fit_fails_with_nan():
    """A Gram that does not factor gives NaN, not an exception: two equal
    training points."""
    x = torch.zeros((3, 9), dtype=torch.float64)
    fit = tgv.archived_mlegp_fit(x, torch.ones(3, dtype=torch.float64))
    low = torch.tril_indices(3, 3)
    assert bool(torch.isnan(fit.chol[low[0], low[1]]).all())
    assert bool(torch.isnan(fit.beta)) and bool(torch.isnan(fit.sigma2))


# ---------------------------------------------------------------------------
# run_study's options
# ---------------------------------------------------------------------------

def small_problem():
    r = np.random.default_rng(5)
    x = r.uniform(size=(10, 2))
    f = lambda v: np.sin(4 * v[:, 0]) + v[:, 1] ** 2  # noqa: E731
    xn = r.uniform(size=(16, 2))
    return x, f(x), xn, f(xn)


def fixed_fit(x, y, make, lib):
    """A KrigingMLE at fixed ARD rates, built by each package from the same
    numpy inputs (lib: the package's gram, Cholesky, GLS functions)."""
    fam, chol_of, beta_of, s2_of, arr = lib
    theta = arr(np.array([2.0, 0.7]))
    chol = chol_of(fam.gram(x, theta))
    beta = beta_of(chol, y)
    return make(beta=beta, sigma2=s2_of(chol, y, beta), theta=theta,
                nll=arr(np.array(0.0)), chol=chol)


OPTION_CASES = {
    "sigma2-mle_ard-jitter-no-cgp": dict(
        sigma2=0.5, mle_ard=True, run_cgp=False, jitter=1e-8,
        single_variant="reference"),
    "mlegp-single_fit": dict(single_fit=True, run_cgp=False,
                             single_variant="mlegp"),
    "mlegp-sigma2-jitter-cgp": dict(sigma2=0.8, jitter=1e-6,
                                    single_variant="mlegp", speculative=4),
    "reference-single_fit": dict(single_fit=True, run_cgp=False,
                                 single_variant="reference", speculative=4),
}
# the cases whose plug-in sigma^2 a BFGS fit makes (kriging_mle's)
BFGS_PLUGIN = {"reference-single_fit"}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_run_study_options_match_jax(case, monkeypatch):
    opts = dict(OPTION_CASES[case])
    jm, tm = mcmc(opts.pop("speculative", 0))
    x, y, xn, yt = small_problem()
    tkw, jkw = dict(opts), dict(opts)
    if opts.get("single_fit"):
        tx, ty = torch.tensor(x), torch.tensor(y)
        tkw["single_fit"] = fixed_fit(
            tx, ty, TMLE, (tkern.sqexp_family(),
                           lambda a: linalg.jitter_cholesky(a, 0.0),
                           gls_beta, sigma2_mle, torch.tensor))
        from ccgp_tpu.ops import linalg as jlinalg
        from ccgp_tpu.ops.gp import gls_beta as jb, sigma2_mle as js2

        jkw["single_fit"] = fixed_fit(
            jnp.asarray(x), jnp.asarray(y), JMLE,
            (jkern.sqexp_family(),
             lambda a: jlinalg.jitter_cholesky(a, 0.0), jb, js2,
             jnp.asarray))
        # a given fit replaces the mlegp fit: it must not run
        monkeypatch.setattr(tcommon, "mlegp_fit", None)
    seen = {}
    for name in ("mlegp_fit", "kriging_mle", "fit_combined_gp"):
        fn = getattr(tcommon, name)
        if fn is None:
            continue

        def spy(*a, _fn=fn, _name=name, **kw):
            seen[_name] = kw.get("jitter")
            return _fn(*a, **kw)
        monkeypatch.setattr(tcommon, name, spy)

    priors = dict(theta1_prior=InverseGamma(3, 2),
                  theta2_prior=InverseGamma(5, 16))
    tres = tcommon.run_study(
        TSpec(tkern.sqexp_family(), tkern.sqexp_family(), dim=2), x, y, xn,
        yt, rng.PRNGKey(2, device="cpu"), tm, device="cpu", **priors, **tkw)
    jres = jcommon.run_study(
        JSpec(jkern.sqexp_family(), jkern.sqexp_family(), dim=2),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(xn), yt,
        jax.random.PRNGKey(2), jm, theta1_prior=JIG(3, 2),
        theta2_prior=JIG(5, 16), **jkw)
    compare(jres, tres, PLUGIN_TOL if case in BFGS_PLUGIN else TOL)
    assert ("cgp" in tres.predictions) == opts.get("run_cgp", True)
    jitter = opts.get("jitter", 0.0)
    assert all(v == jitter for v in seen.values()), seen
    assert "fit_combined_gp" in seen
    if "sigma2" in opts:
        assert float(tres.fit.sigma2) == opts["sigma2"]
    elif opts["single_variant"] == "mlegp":     # the given fit's plug-in
        assert float(tres.fit.sigma2) == float(tkw["single_fit"].sigma2)
    else:                                       # the fit's own plug-in
        assert float(tres.fit.sigma2) == float(tres.fit.mle.sigma2)


# ---------------------------------------------------------------------------
# the three studies
# ---------------------------------------------------------------------------

def test_ground_vibrations_default_matches_jax(gv_root, at_root):
    """The default (non-compat) path at n = 50, d = 9: `mlegp_fit`'s 49
    starts give the plug-in and the baseline; speculative K = 4."""
    at_root(gv_root)
    jm, tm = mcmc(4)
    jres = jgv.run(jgv.Config(mcmc=jm), key=jax.random.PRNGKey(1),
                   run_cgp=False)
    tres = tgv.run(tgv.Config(mcmc=tm), key=rng.PRNGKey(1, device="cpu"),
                   run_cgp=False, device="cpu")
    compare(jres, tres, PLUGIN_TOL)
    assert set(tres.predictions) == {"combined", "single"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_ground_vibrations_prints_jax_lines(gv_root, at_root,
                                               monkeypatch, capsys):
    """Both CLIs on the golden split with the archived fit
    (compat_mlegp), --fast, --f64, seed 1: the same chain, predictions of
    all three models (the one GV run with the composite GP) and printed
    lines."""
    at_root(gv_root)
    runs = {}
    for name, mod in (("port", tgv), ("jax", jgv)):
        @dataclass(frozen=True)
        class Compat(mod.Config):
            compat_mlegp: bool = True

        monkeypatch.setattr(mod, "Config", Compat)
        real = mod.run

        def capture(*a, _real=real, _name=name, **kw):
            runs[_name] = _real(*a, **kw)
            return runs[_name]
        monkeypatch.setattr(mod, "run", capture)
    assert tcli.main(["ground_vibrations", "--fast", "--cpu", "--f64",
                      "--seed", "1"]) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert jcli.main(["ground_vibrations", "--fast", "--cpu", "--f64",
                      "--seed", "1"]) == 0
    jax_out = capsys.readouterr().out.splitlines()
    assert port_out == jax_out and len(port_out) == 3
    assert port_out[0].startswith("RMSPE:") and "cgp" in port_out[0]
    compare(runs["jax"], runs["port"])


def test_cli_needs_cuda_unless_cpu_is_asked_for(gv_root, at_root,
                                                monkeypatch):
    at_root(gv_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for study in ("ground_vibrations", "heat_exchanger",
                  "sim_2d_iso_advanced"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main([study, "--fast", "--f64"])


def test_cli_without_the_data_files_fails_naming_the_root(tmp_path):
    env = {**os.environ, "CCGP_DATA_ROOT": "", "HOME": str(tmp_path)}
    for study in ("ground_vibrations", "heat_exchanger",
                  "sim_2d_iso_advanced"):
        r = subprocess.run([sys.executable, "-m", "ccgp_tpu_torch", study,
                            "--cpu", "--fast"], env=env,
                           capture_output=True, text=True, timeout=300,
                           cwd=ROOT)
        assert r.returncode != 0
        assert "FileNotFoundError" in r.stderr and "CCGP_DATA_ROOT" in r.stderr
