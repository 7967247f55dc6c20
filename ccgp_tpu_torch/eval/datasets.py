"""Loaders for the reference case-study data (port of
`ccgp_tpu/eval/datasets.py`, numpy only, its own copy).

The reference ships text fixtures: designs, train/test splits and
hyperprior grids (SURVEY.md section 2.6 and the reference's `ReadMe.md`).
These loaders parse the original files in place under a data root: the
CCGP_DATA_ROOT environment variable, else the reference checkout at
`~/reference`. The files are not in this repository.

All loaders return numpy arrays; call sites move them to the device.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_DEFAULT_ROOTS = (
    os.environ.get("CCGP_DATA_ROOT", ""),
    str(Path("~/reference").expanduser()),
)


def data_root() -> Path:
    for r in _DEFAULT_ROOTS:
        if r and Path(r).is_dir():
            return Path(r)
    raise FileNotFoundError(
        "reference data root not found; set CCGP_DATA_ROOT"
    )


def _read_table(path: Path, header: bool) -> np.ndarray:
    """Parse an R write.table/read.table text file.

    header=True files carry a quoted column-name row and quoted row names in
    the first column (R's default write.table format).
    """
    rows = []
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    start = 1 if header else 0
    for ln in lines[start:]:
        parts = ln.replace("\t", " ").split()
        if header and parts and parts[0].startswith('"'):
            parts = parts[1:]  # drop quoted row name
        rows.append([float(p) for p in parts])
    return np.asarray(rows)


def _columns(path: Path) -> list[str]:
    with open(path) as fh:
        first = fh.readline()
    return [c.strip('"') for c in first.replace("\t", " ").split()]


def load_qian(root: Path | None = None):
    """Heat-exchanger (Qian et al. 2006) train/test sets.

    Returns dict with x_train (64,4), y_train (64,), x_test (14,4),
    y_test (14,) — columns (m, Tin, k, Twall) -> response ya
    (`Heat Exchanger Emulator/Combined GP Heat Exchanger.R:749-757`).
    """
    root = root or data_root()
    d = root / "Heat Exchanger Emulator"
    tr = _read_table(d / "Qian Training Set.txt", header=True)
    te = _read_table(d / "Qian Test Set.txt", header=True)
    return {
        "x_train": tr[:, :4], "y_train": tr[:, 4],
        "x_test": te[:, :4], "y_test": te[:, 4],
    }


def load_ground_vibrations(size: int, sample: int, root: Path | None = None):
    """Ground-vibrations train/test split (9-D, standardized inputs).

    size in {50, 90}, sample 1..9 (size 50) / 1..8 (size 90)
    (`Ground Vibrations Emulator/Combined GP Ground Vibrations.R:707-718`).
    """
    root = root or data_root()
    d = root / "Ground Vibrations Emulator"
    tr = _read_table(
        d / "Training Sets" / f"Training Set Size {size} Sample {sample}.txt",
        header=True)
    te = _read_table(
        d / "Test Sets" / f"Test Set Size {size} Sample {sample}.txt",
        header=True)
    return {
        "x_train": tr[:, :9], "y_train": tr[:, 9],
        "x_test": te[:, :9], "y_test": te[:, 9],
    }


def load_maximin_2d(n: int, root: Path | None = None) -> np.ndarray:
    """JMP maximin LHDs: n in {14, 100}
    (`2D Codes and Designs/maximin {n} pts.txt`, no header)."""
    root = root or data_root()
    return _read_table(root / "2D Codes and Designs" / f"maximin {n} pts.txt",
                       header=False)


def load_1d_designs(root: Path | None = None) -> np.ndarray:
    """100 size-8 1-D LHDs, one per row (returns (100, 8))."""
    root = root or data_root()
    return _read_table(
        root / "1D Codes and Designs" / "1D Combined GP Simulation Designs.txt",
        header=True)


def load_2d_training_design(i: int, root: Path | None = None) -> np.ndarray:
    """Train_Design_{1..100}.txt: size-14 2-D LHDs."""
    root = root or data_root()
    return _read_table(
        root / "2D Codes and Designs" / "Training Designs" / f"Train_Design_{i}.txt",
        header=True)


def load_hyperpars_grid(which: str = "2d", root: Path | None = None) -> np.ndarray:
    """(a1,b1,a2,b2) inverse-gamma hyperparameter grids: '2d' (60 x 4) or
    'heat' (624 x 4)."""
    root = root or data_root()
    sub = ("2D Codes and Designs" if which == "2d"
           else "Heat Exchanger Emulator")
    return _read_table(root / sub / "hyperpars.matrix.txt", header=True)


def load_initial_me_design(root: Path | None = None) -> np.ndarray:
    """Size-14 maximum-entropy design for (p=0.5, theta1=1, theta2=4) on
    [-1,1]^2 (`Batch Sequential ME Designs/Initial ME Design.txt`)."""
    root = root or data_root()
    return _read_table(
        root / "Batch Sequential ME Designs" / "Initial ME Design.txt",
        header=False)


def load_design_txt(name: str, header: bool = False,
                    root: Path | None = None) -> np.ndarray:
    """Generic loader for the batch-design artifacts (maximin 21 pts,
    All_Subdesigns, k-medoids ME Design, Plug-in ME 14 plus 7 Design)."""
    root = root or data_root()
    return _read_table(root / "Batch Sequential ME Designs" / f"{name}.txt",
                       header=header)


def load_gv_archived_results(root: Path | None = None):
    """The archived golden table `Ground Vibrations Emulator/Results/Size 50
    Results 1.txt` (150 rows x 20 cols) with column names."""
    root = root or data_root()
    p = root / "Ground Vibrations Emulator" / "Results" / "Size 50 Results 1.txt"
    return _columns(p), _read_table(p, header=True)
