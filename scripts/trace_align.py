"""A traced run of a cell through the harness, in one process, with the
program's own records beside the wrappers' spans.

    python3 scripts/trace_align.py --workload <cell> --seed <n> [--seconds 51]

Prints one JSON object: the run's metrics and `correct`; for a fit cell
the program's `laplace` and `plugin` means and sampler time per kept
round (to set beside `laplace_ms.fit`, `plugin_ms.fit` and
`sampler_us_per_round.fit`), the self ms a fit by span path; the idle
seconds of the profiled requests by program path, the share of them that
carries a program path, and the top labels.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import torch  # noqa: E402

torch.set_num_threads(1)
from harness import cell as hcell, check, program, spec  # noqa: E402

WRAPPER_ONLY = ("metropolis", "outside spans")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args()
    captured = {}
    orig = spec.metric_reader

    def reader(name):
        fn = orig(name)

        def read(tr):
            captured["tr"] = tr
            return fn(tr)
        return read

    spec.metric_reader = reader
    c = spec.load_cell(args.workload, ROOT)
    res = hcell.run(c, args.seed, args.seconds, True, "cuda", T_START)
    correct, _ = check.judge(res["numbers"], c.limits)
    tr = captured["tr"]
    recs = program.window_records(tr)
    out = {"workload": args.workload, "seed": args.seed, "correct": correct,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "window_records": len(recs)}
    if tr.kind == "fit_predict":
        out["program_laplace_ms"] = statistics.mean(
            program.span_ns(r, "laplace") for r in recs) / 1e6
        out["program_plugin_ms"] = statistics.mean(
            program.span_ns(r, "plugin") for r in recs) / 1e6
        out["program_sampler_us_per_round"] = 1e-3 * sum(
            program.span_ns(r, "sampler") for r in recs) / sum(
            program.counter(r, "rounds.kept", "sampler") for r in recs)
        out["rounds_kept_equals_n_rounds"] = [
            sum(program.counter(r, "rounds.kept", "sampler") for r in recs),
            sum(r["n_rounds"] for r in tr.requests)]
        out["fit_ms"] = statistics.mean(r["ns"] for r in recs) / 1e6
        self_ns = {}
        for r in recs:
            self_ns[""] = self_ns.get("", 0) + r["ns"] - r["child_ns"]
            for p, (n, tot, ch) in r["spans"].items():
                self_ns[p] = self_ns.get(p, 0) + tot - ch
        out["self_ms_per_fit"] = {p: v / 1e6 / len(recs) for p, v in
                                  sorted(self_ns.items(),
                                         key=lambda kv: -kv[1])[:14]}
    else:
        out["program_moments_ms"] = statistics.mean(
            program.span_ns(r, "moments") for r in recs) / 1e6
        out["program_intervals_ms"] = statistics.mean(
            program.span_ns(r, "intervals") for r in recs) / 1e6
    gaps = tr.profile["gaps"]
    total = sum(gaps.values())
    wrap = sum(v for k, v in gaps.items()
               if k.split(": ", 1)[0] in WRAPPER_ONLY)
    out["idle_s"] = total
    out["idle_share_on_program_paths"] = 1 - wrap / total if total else None
    out["idle_wrapper_only"] = {k: v for k, v in gaps.items()
                                if k.split(": ", 1)[0] in WRAPPER_ONLY}
    by_path = {}
    for k, v in gaps.items():
        p = k.split(": ", 1)[0]
        by_path[p] = by_path.get(p, 0) + v
    out["idle_by_path"] = dict(sorted(by_path.items(), key=lambda kv: -kv[1]))
    out["top_labels"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:8]
    out["busy_s"], out["window_s"] = tr.profile["busy_s"], tr.profile["window_s"]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
