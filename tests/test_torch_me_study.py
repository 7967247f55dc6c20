"""The batch-sequential maximum-entropy design study, its data loaders
and its CLI, on the CPU, float64, against the JAX package.

`batch_me_design.run` with `regenerate_first=True` (no data file) at a
small size: 8 + 3 points, 3 starts, the CLI's --fast MCMC budget with
speculative K = 4, a 5 x 5 lattice. JAX takes its one-round sampler on
the CPU and the port the chunked driver (law-equal: the chain counters
are equal). Tolerances: the designs and the plug-in carry BFGS's stopping
point, 1e-6; the second batch's log-entropy 1e-9; predictions and RMSPE
1e-6 relative to max(1, |value|). Coverage and calibration are compared
on the lattice points off the design: the ME designs put points on the
lattice's corners, where the single GP's interval and the combined GP's
draws have a width of rounding size, so whether the truth lies inside is
decided by rounding in either package.

The loaders run on synthetic files in the reference's R table formats,
under a temporary data root.
"""
import os
import subprocess
import sys
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccgp_tpu.eval import datasets as jdata
from ccgp_tpu.experiments import batch_me_design as jbmd
from ccgp_tpu.models import MCMCConfig as JCfg
from ccgp_tpu_torch.__main__ import main
from chip_smoke import off_design
from ccgp_tpu_torch.eval import datasets as tdata
from ccgp_tpu_torch.experiments import batch_me_design as tbmd
from ccgp_tpu_torch.models.combined_gp import MCMCConfig
from ccgp_tpu_torch.ops import rng

FAST = dict(start=(1.0, 1.0, 0.0), n_max=1200, samp_size=300,
            net_samp_size=200, speculative=4)
SMALL = dict(regenerate_first=True, n_first=8, n_second=3, n_starts=3,
             n_new_axis=5)


def close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.fixture(scope="module")
def runs():
    jres = jbmd.run(jbmd.Config(**SMALL, mcmc=JCfg(**FAST)),
                    key=jax.random.PRNGKey(0), dtype=jnp.float64)
    tres = tbmd.run(tbmd.Config(**SMALL, mcmc=MCMCConfig(**FAST)),
                    key=rng.PRNGKey(0, device="cpu"), device="cpu")
    return jres, tres


def test_designs_and_plug_in_match_jax(runs):
    jres, tres = runs
    close(tres.d_first, jres.d_first, 1e-6)
    close(tres.d_second, jres.d_second, 1e-6)
    for f in ("p", "theta1", "theta2"):
        close(getattr(tres.plug_in_params, f),
              getattr(jres.plug_in_params, f), 1e-6)
    close(tres.log_entropy, jres.log_entropy, 1e-9)
    for d in (tres.d_first, tres.d_second):
        assert np.all(np.abs(d) <= 1.0)
    assert tres.fit.chain_ok and tres.d_second_kmedoids is None


def test_refit_study_matches_jax(runs):
    jres, tres = runs
    js, ts = jres.study, tres.study
    for a in ("n_recorded", "n_proposals", "n_rounds", "converged"):
        assert getattr(ts.fit.mcmc, a) == getattr(js.fit.mcmc, a).item(), a
    for m in js.predictions:
        for f in ("mean", "lower", "upper"):
            close(getattr(ts.predictions[m], f),
                  getattr(js.predictions[m], f), 1e-6)
        close(ts.summary.rmspe[m], js.summary.rmspe[m], 1e-6)
    t_cov, t_q = off_design(tres, SMALL["n_new_axis"])
    j_cov, j_q = off_design(jres, SMALL["n_new_axis"])
    assert t_cov == j_cov
    close(t_q, j_q, 1e-6)


def test_kmedoids_variant():
    """kmedoids_draws > 0: one subdesign per posterior draw, clustered to
    n_second medoids, each a point of the cloud inside the box."""
    cfg = tbmd.Config(**{**SMALL, "n_first": 6, "n_second": 2},
                      kmedoids_draws=2, mcmc=MCMCConfig(**FAST))
    res = tbmd.run(cfg, key=rng.PRNGKey(1, device="cpu"), device="cpu",
                   refit=False)
    assert res.study is None
    assert res.d_second_kmedoids.shape == (2, 2)
    assert np.all(np.abs(res.d_second_kmedoids) <= 1.0)


# ---------------------------------------------------------------------------
# eval/datasets on synthetic files
# ---------------------------------------------------------------------------

def _write(path, rows, header=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    if header is not None:
        lines.append(" ".join(f'"{c}"' for c in header))
    for i, row in enumerate(rows):
        cells = [repr(float(v)) for v in row]
        lines.append("\t".join(cells) if header is None
                     else " ".join([f'"{i + 1}"'] + cells))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    r = np.random.default_rng(0)
    cols = lambda k: [f"V{j}" for j in range(k)]  # noqa: E731
    he = root / "Heat Exchanger Emulator"
    _write(he / "Qian Training Set.txt", r.normal(size=(64, 5)), cols(5))
    _write(he / "Qian Test Set.txt", r.normal(size=(14, 5)), cols(5))
    _write(he / "hyperpars.matrix.txt", r.uniform(size=(624, 4)), cols(4))
    gv = root / "Ground Vibrations Emulator"
    _write(gv / "Training Sets" / "Training Set Size 50 Sample 2.txt",
           r.normal(size=(50, 10)), cols(10))
    _write(gv / "Test Sets" / "Test Set Size 50 Sample 2.txt",
           r.normal(size=(100, 10)), cols(10))
    _write(gv / "Results" / "Size 50 Results 1.txt",
           r.normal(size=(150, 20)), cols(20))
    d2 = root / "2D Codes and Designs"
    _write(d2 / "maximin 14 pts.txt", r.uniform(size=(14, 2)))
    _write(d2 / "Training Designs" / "Train_Design_3.txt",
           r.uniform(size=(14, 2)), cols(2))
    _write(d2 / "hyperpars.matrix.txt", r.uniform(size=(60, 4)), cols(4))
    _write(root / "1D Codes and Designs"
           / "1D Combined GP Simulation Designs.txt",
           r.uniform(size=(100, 8)), cols(8))
    me = root / "Batch Sequential ME Designs"
    _write(me / "Initial ME Design.txt", r.uniform(-1, 1, size=(14, 2)))
    _write(me / "All_Subdesigns.txt", r.uniform(-1, 1, size=(70, 2)),
           cols(2))
    return root


LOADERS = [
    ("load_qian", ()), ("load_ground_vibrations", (50, 2)),
    ("load_maximin_2d", (14,)), ("load_1d_designs", ()),
    ("load_2d_training_design", (3,)), ("load_hyperpars_grid", ("2d",)),
    ("load_hyperpars_grid", ("heat",)), ("load_initial_me_design", ()),
    ("load_gv_archived_results", ()),
]


@pytest.mark.parametrize("name,args", LOADERS)
def test_loaders_equal_jax(data_root, name, args):
    got = getattr(tdata, name)(*args, root=data_root)
    ref = getattr(jdata, name)(*args, root=data_root)
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        got, ref = list(got.values()), list(ref.values())
    elif isinstance(ref, tuple):
        assert got[0] == ref[0]
        got, ref = [got[1]], [ref[1]]
    else:
        got, ref = [got], [ref]
    for g, f in zip(got, ref):
        assert g.shape == f.shape and np.array_equal(g, f)
    design = tdata.load_design_txt("All_Subdesigns", header=True,
                                   root=data_root)
    assert design.shape == (70, 2) and np.array_equal(
        design, jdata.load_design_txt("All_Subdesigns", header=True,
                                      root=data_root))


def test_data_root_from_the_environment(data_root, monkeypatch):
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "_DEFAULT_ROOTS", (str(data_root),))
    assert tdata.data_root() == jdata.data_root() == data_root
    assert np.array_equal(tdata.load_initial_me_design(),
                          jdata.load_initial_me_design())


def test_missing_root_raises_as_jax(tmp_path, monkeypatch):
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "_DEFAULT_ROOTS",
                            ("", str(tmp_path / "absent")))
    with pytest.raises(FileNotFoundError) as t_err:
        tdata.load_initial_me_design()
    with pytest.raises(FileNotFoundError) as j_err:
        jdata.load_initial_me_design()
    assert str(t_err.value) == str(j_err.value)
    assert "CCGP_DATA_ROOT" in str(t_err.value)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_without_the_data_file_fails_naming_the_root(tmp_path):
    env = {**os.environ, "CCGP_DATA_ROOT": "", "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "ccgp_tpu_torch",
                        "batch_me_design", "--cpu"], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode != 0
    assert "FileNotFoundError" in r.stderr and "CCGP_DATA_ROOT" in r.stderr


def test_cli_prints_the_second_batch(monkeypatch, capsys):
    @dataclass(frozen=True)
    class Regenerate(tbmd.Config):
        regenerate_first: bool = True
        n_first: int = 8
        n_second: int = 3
        n_starts: int = 3
        n_new_axis: int = 5

    monkeypatch.setattr(tbmd, "Config", Regenerate)
    assert main(["batch_me_design", "--fast", "--cpu", "--f64",
                 "--speculative", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("RMSPE:") and "single" in out[0]
    assert out[1].startswith("coverage:")
    assert out[2].startswith("calibration quantile:")
    assert out[3] == "second-batch design:"
    rows = [np.fromstring(line.strip(" []"), sep=" ") for line in out[4:]]
    assert len(rows) == 3 and all(len(v) == 2 for v in rows)
    assert all(np.all(np.abs(v) <= 1.0) for v in rows)
