"""Freeze the ground-vibrations size-50 splits into `gv_size50_splits.json`.

    python3 benchmark/data/make_gv_splits.py

A copy of `chip_smoke.gv_data_root`'s rebuild, kept here so that the
benchmark's data cannot move with the script: table i of
`results/GV Size 50 Results {1..9}.txt` holds the 150 test points of
sample i, in test-set order, with their 9 standardized inputs and
`y.true`; the nine tables together hold the 200 points of the data set,
so sample i's training set is the 50 points not in table i. Points are
stored in the order of their first appearance across tables 1..9 (the
training rows' order); each split lists its training and test points'
indices into them. The benchmark reads only the frozen file.
"""
import json
from pathlib import Path

INPUTS = ["slope", "angle", "top.layer3", "bot.layer3", "vs2", "vs3", "vs4",
          "density", "freq"]
POINTS, TRAIN = 200, 50
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def read_table(path: Path):
    """An R `write.table` file: a quoted header, then a quoted row name
    and the values on each line."""
    lines = path.read_text().splitlines()
    head = [h.strip('"') for h in lines[0].split()]
    rows = [[float(v) for v in line.split()[1:]] for line in lines[1:]
            if line.strip()]
    return head, rows


def build() -> dict:
    tables = {}
    for i in range(1, 10):
        head, rows = read_table(ROOT / "results"
                                / f"GV Size 50 Results {i}.txt")
        cols = [head.index(c) for c in INPUTS + ["y.true"]]
        tables[i] = [tuple(r[c] for c in cols) for r in rows]
    order = {}
    for i in range(1, 10):
        for r in tables[i]:
            order.setdefault(r, len(order))
    if len(order) != POINTS:
        raise ValueError(f"the tables hold {len(order)} points, not "
                         f"{POINTS}")
    splits = []
    for i in range(1, 10):
        test = [order[r] for r in tables[i]]
        held = set(test)
        train = [j for j in range(POINTS) if j not in held]
        if len(train) != TRAIN or len(set(test)) != POINTS - TRAIN:
            raise ValueError(f"sample {i}: {len(train)} training and "
                             f"{len(set(test))} test points")
        splits.append({"sample": i, "train": train, "test": test})
    return {"columns": INPUTS + ["y"], "points": [list(r) for r in order],
            "splits": splits}


if __name__ == "__main__":
    out = HERE / "gv_size50_splits.json"
    with open(out, "w") as fh:
        json.dump(build(), fh)
    print(out)
