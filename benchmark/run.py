"""Run one cell of the benchmark of `ccgp_tpu_torch` once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files by the names in BENCHMARK.json, sets up, warms up
one request of the cell's own shapes, measures a closed loop for
`--seconds`, checks the answers against the plain reference and prints
one JSON line last on standard output. With --trace 0 the metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics. Exits
non-zero, printing no result, without a CUDA card, without the package
beside this folder, or when JAX or the JAX package was imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ccgp_tpu")
CACHE_DIR = BENCH_DIR / ".cache"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (`ccgp_tpu_torch` is not
    `ccgp_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(v):
    """JSON has no infinity: a non-finite number is written as null."""
    if isinstance(v, dict):
        return {k: finite(x) for k, x in v.items()}
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches of the card's toolchains at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)
    # one process with few threads: the host side is serial Python, and
    # idle OpenMP workers only add noise to it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if not (ROOT / "ccgp_tpu_torch" / "__init__.py").is_file():
        fail(f"the package ccgp_tpu_torch is not beside {BENCH_DIR.name}/")
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    import torch

    torch.set_num_threads(1)
    from harness import check, spec
    from harness.cell import run

    cell = spec.load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
             f"present")

    res = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              T_START)
    correct, checks = check.judge(res["numbers"], cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        if "busy_s" not in res:
            fail("the traced run profiled no request")
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line), allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
