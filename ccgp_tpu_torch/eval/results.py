"""Result tables in the reference's format (port of
`ccgp_tpu/eval/results.py`, numpy only, its own copy).

The ground-vibrations study writes one R `write.table` file per training
sample with the per-test-point predictions of the three models (`Ground
Vibrations Emulator/Combined GP Ground Vibrations.R:759-761`; archived
example `Results/Size 50 Results 1.txt`). These functions write and read
tables of that structure, so a summary can be recomputed from either
source.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from ccgp_tpu_torch.eval.compare import ModelPrediction, comparison_summary

GV_COLUMNS = [
    "y.hat.Combined", "Quant.Combined", "LL.Combined", "UL.Combined",
    "y.hat.single", "LL.single", "UL.single",
    "y.hat.CGP", "LL.CGP", "UL.CGP", "y.true",
]


def write_comparison_table(path: str | Path, x_test: np.ndarray,
                           x_names: list[str],
                           predictions: Dict[str, ModelPrediction],
                           y_true: np.ndarray) -> None:
    """R write.table format: quoted header, quoted 1-based row names,
    values as `repr(float)`; the inputs' columns, then each model's."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cols = {nm: np.asarray(x_test)[:, i] for i, nm in enumerate(x_names)}
    name_map = {"combined": "Combined", "single": "single", "cgp": "CGP"}
    for key, pred in predictions.items():
        suffix = name_map.get(key, key)
        cols[f"y.hat.{suffix}"] = np.asarray(pred.mean)
        if key == "combined" and pred.quant is not None:
            cols["Quant.Combined"] = np.asarray(pred.quant)
        if pred.lower is not None:
            cols[f"LL.{suffix}"] = np.asarray(pred.lower)
            cols[f"UL.{suffix}"] = np.asarray(pred.upper)
    cols["y.true"] = np.asarray(y_true)

    names = list(cols)
    with open(path, "w") as fh:
        fh.write(" ".join(f'"{n}"' for n in names) + "\n")
        for r in range(len(cols["y.true"])):
            vals = " ".join(repr(float(cols[n][r])) for n in names)
            fh.write(f'"{r + 1}" {vals}\n')


def read_comparison_table(path: str | Path):
    """A table written by `write_comparison_table` (or by R) as
    (column names, (rows, columns) array)."""
    with open(path) as fh:
        header = [c.strip('"') for c in fh.readline().split()]
        rows = [[float(v) for v in ln.split()[1:]] for ln in fh]
    return header, np.asarray(rows)


def summary_from_table(path: str | Path):
    """The RMSPE / coverage / calibration summary recomputed from a
    persisted table."""
    cols, tab = read_comparison_table(path)

    def get(name):
        return tab[:, cols.index(name)]

    preds = {}
    if "y.hat.Combined" in cols:
        preds["combined"] = ModelPrediction(
            get("y.hat.Combined"), get("LL.Combined"), get("UL.Combined"),
            get("Quant.Combined") if "Quant.Combined" in cols else None)
    if "y.hat.single" in cols:
        preds["single"] = ModelPrediction(
            get("y.hat.single"), get("LL.single"), get("UL.single"))
    if "y.hat.CGP" in cols:
        preds["cgp"] = ModelPrediction(
            get("y.hat.CGP"), get("LL.CGP"), get("UL.CGP"))
    return comparison_summary(get("y.true"), preds)
