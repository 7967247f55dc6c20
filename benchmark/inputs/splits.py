"""Inputs of configurations with "data": "splits": the train/test splits
of `data_file` (JSON under the checkout: `points`, rows of dim inputs and
y, and `splits`, each with `train` and `test` row indices). Design i of
seed s is split (s + i) mod the number of splits."""
import numpy as np

from harness.spec import ROOT, load_json

_FILES = {}


def design(cfg: dict, seed: int, i: int):
    """(x, y, new points) as float64 arrays."""
    path = cfg["data_file"]
    if path not in _FILES:
        data = load_json(ROOT / path)
        _FILES[path] = (np.asarray(data["points"], dtype=np.float64),
                        data["splits"])
    pts, splits = _FILES[path]
    split = splits[(int(seed) + int(i)) % len(splits)]
    tr, te, d = pts[split["train"]], pts[split["test"]], cfg["dim"]
    return tr[:, :d], tr[:, d], te[:, :d]
