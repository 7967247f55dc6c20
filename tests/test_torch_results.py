"""The result tables (`eval/results.py`) on the CPU against the JAX
package: the summaries of the repo's ground-vibrations tables, a write /
read round trip, and tables written by one package read by the other.
numpy in and out on both sides, so the summaries agree to 1e-12."""
from pathlib import Path

import numpy as np
import pytest

from ccgp_tpu.eval import results as jres
from ccgp_tpu_torch.eval import results as tres
from ccgp_tpu_torch.eval.compare import ModelPrediction

ROOT = Path(__file__).resolve().parent.parent
TABLES = ([ROOT / "results" / f"GV Size 50 Results {i}.txt"
           for i in range(1, 10)]
          + [ROOT / "results_compat_mlegp" / "GV Size 50 Results 1.txt"])
TOL = 1e-12


def same_summary(got, ref, tol=TOL):
    assert set(got.rmspe) == set(ref.rmspe)
    assert set(got.coverage) == set(ref.coverage)
    for k in ref.rmspe:
        assert abs(got.rmspe[k] - ref.rmspe[k]) <= tol * max(1.0, ref.rmspe[k])
    for k in ref.coverage:
        assert abs(got.coverage[k] - ref.coverage[k]) <= tol
    if ref.average_quantile is None:
        assert got.average_quantile is None
    else:
        assert abs(got.average_quantile - ref.average_quantile) <= tol


@pytest.mark.parametrize("path", TABLES, ids=lambda p: f"{p.parent.name}-"
                         f"{p.stem.split()[-1]}")
def test_summary_from_table_matches_jax(path):
    same_summary(tres.summary_from_table(path), jres.summary_from_table(path))
    cols, tab = tres.read_comparison_table(path)
    jcols, jtab = jres.read_comparison_table(path)
    assert cols == jcols and np.array_equal(tab, jtab)
    assert cols[-len(tres.GV_COLUMNS):] == tres.GV_COLUMNS == jres.GV_COLUMNS
    assert tab.shape == (150, 20)


def predictions(seed, quant=True):
    g = np.random.default_rng(seed)
    y = g.normal(size=12)
    mean = y + 0.1 * g.normal(size=12)
    half = np.abs(g.normal(size=12))
    preds = {"combined": ModelPrediction(
        mean, mean - half, mean + half, g.uniform(size=12) if quant else None),
        "single": ModelPrediction(mean + 0.05, mean - 2 * half,
                                  mean + 2 * half),
        "cgp": ModelPrediction(mean - 0.05, mean - half / 2,
                               mean + half / 2)}
    return g.normal(size=(12, 3)), y, preds


@pytest.mark.parametrize("quant", [True, False])
def test_write_read_round_trip(tmp_path, quant):
    x, y, preds = predictions(0, quant)
    path = tmp_path / "sub" / "table.txt"
    tres.write_comparison_table(path, x, ["a", "b", "c"], preds, y)
    cols, tab = tres.read_comparison_table(path)
    want = ["a", "b", "c", "y.hat.Combined"] + (
        ["Quant.Combined"] if quant else []) + [
        "LL.Combined", "UL.Combined", "y.hat.single", "LL.single",
        "UL.single", "y.hat.CGP", "LL.CGP", "UL.CGP", "y.true"]
    assert cols == want
    assert np.array_equal(tab[:, :3], x)
    assert np.array_equal(tab[:, cols.index("y.true")], y)
    for name, suffix in (("combined", "Combined"), ("single", "single"),
                         ("cgp", "CGP")):
        p = preds[name]
        assert np.array_equal(tab[:, cols.index(f"y.hat.{suffix}")], p.mean)
        assert np.array_equal(tab[:, cols.index(f"LL.{suffix}")], p.lower)
        assert np.array_equal(tab[:, cols.index(f"UL.{suffix}")], p.upper)
    lines = path.read_text().splitlines()
    assert lines[0].startswith('"a" "b" "c" "y.hat.Combined"')
    assert lines[1].startswith('"1" ') and lines[-1].startswith('"12" ')
    from ccgp_tpu_torch.eval.compare import comparison_summary

    same_summary(tres.summary_from_table(path), comparison_summary(y, preds))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tables_cross_read(tmp_path, writer):
    x, y, preds = predictions(1)
    path = tmp_path / "t.txt"
    (tres if writer == "port" else jres).write_comparison_table(
        path, x, ["u", "v", "w"], preds, y)
    reader = jres if writer == "port" else tres
    cols, tab = reader.read_comparison_table(path)
    other = tmp_path / "o.txt"
    (jres if writer == "port" else tres).write_comparison_table(
        other, x, ["u", "v", "w"], preds, y)
    assert path.read_text() == other.read_text()
    same_summary(reader.summary_from_table(path),
                 (tres if writer == "port" else jres).summary_from_table(path))
    assert tab.shape == (12, 3 + 11)
