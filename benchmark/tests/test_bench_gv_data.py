"""The frozen GV splits are `chip_smoke.gv_data_root`'s, bit for bit."""
import json

import numpy as np

from harness.spec import BENCH_DIR, ROOT


def test_frozen_splits_match_chip_smoke(tmp_path):
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ccgp_tpu_torch.eval.datasets import load_ground_vibrations

    data = json.loads((BENCH_DIR / "data" / "gv_size50_splits.json")
                      .read_text())
    pts = np.asarray(data["points"], dtype=np.float64)
    root = chip_smoke.gv_data_root(tmp_path)
    assert len(data["splits"]) == 9
    for s in data["splits"]:
        assert len(s["train"]) == 50 and len(s["test"]) == 150
        gv = load_ground_vibrations(50, s["sample"], root=root)
        tr, te = pts[s["train"]], pts[s["test"]]
        assert np.array_equal(tr[:, :9], gv["x_train"])
        assert np.array_equal(tr[:, 9], gv["y_train"])
        assert np.array_equal(te[:, :9], gv["x_test"])
        assert np.array_equal(te[:, 9], gv["y_test"])


def test_builder_reproduces_the_file():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_gv_splits", BENCH_DIR / "data" / "make_gv_splits.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    frozen = json.loads((BENCH_DIR / "data" / "gv_size50_splits.json")
                        .read_text())
    assert mod.build() == frozen
