"""The command itself: it refuses to measure without a card or without
the package beside its folder, printing no result; on the card a short
run prints a well-formed, correct last line."""
import json
import shutil
import subprocess
import sys

import pytest

from harness.spec import BENCH_DIR, ROOT

ARGS = ["--workload", "bench2d.n100", "--seed", str(2**31 + 9),
        "--seconds", "2", "--trace", "0"]


def _run(root, env=None, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.card
def test_short_run_on_the_card(card):
    p = _run(ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"fit_predict_ms", "fit_predict_p80_ms",
                                    "setup_s"}
