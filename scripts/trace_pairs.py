"""Untraced runs of one benchmark cell on two checkouts, and on the second
with the tracer off, in turns: what the tracer costs end to end.

    python3 scripts/trace_pairs.py --parent <dir> --change <dir> \
        --workload gv9d.splits --seeds 1,2,3,4 [--seconds 51] [--out <dir>]

For each seed, three runs of `benchmark/run.py --trace 0`, each launched
as the benchmark launches it, from its checkout: `parent`, `change`, and
`level0` (the change with CCGP_TRACE_LEVEL=0 in its environment). The
order turns with the seed, so that no side always runs first. Prints one
line per run and a summary: each end-to-end metric's median per side and
how many seeds read the change, and level 0, above the parent."""
import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

SIDES = ("parent", "change", "level0")
ORDERS = (SIDES, ("level0", "parent", "change"), ("change", "level0", "parent"),
          ("parent", "level0", "change"))


def one(side, root, args, seed, out):
    env = dict(os.environ)
    env.pop("CCGP_TRACE_LEVEL", None)
    if side == "level0":
        env["CCGP_TRACE_LEVEL"] = "0"
    cmd = [sys.executable, "benchmark/run.py", "--workload", args.workload,
           "--seed", str(seed), "--seconds", str(args.seconds),
           "--trace", "0"]
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=args.seconds + 600)
    if out is not None:
        (out / f"{side}_{seed}.json").write_text(r.stdout)
        (out / f"{side}_{seed}.err").write_text(r.stderr)
    try:
        res = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        print(side, seed, "no result, exit", r.returncode, flush=True)
        return None
    vals = {k: v["value"] for k, v in res["metrics"].items()}
    print(side, seed, res.get("correct"), res.get("attempted"),
          res.get("failed"), json.dumps(vals), flush=True)
    return vals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    roots = {"parent": args.parent, "change": args.change,
             "level0": args.change}
    got = {s: {} for s in SIDES}
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for side in ORDERS[j % len(ORDERS)]:
            v = one(side, roots[side], args, seed, out)
            if v is not None:
                got[side][seed] = v
    names = sorted({k for s in got.values() for v in s.values() for k in v})
    summary = {}
    for name in names:
        row = {}
        for side in SIDES:
            xs = [v[name] for v in got[side].values() if name in v]
            row[side + "_median"] = statistics.median(xs) if xs else None
        for side in ("change", "level0"):
            both = [s for s in got[side] if s in got["parent"]
                    and name in got[side][s] and name in got["parent"][s]]
            row[side + "_above_parent"] = (
                f"{sum(got[side][s][name] > got['parent'][s][name] for s in both)}"
                f" of {len(both)}")
        summary[name] = row
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)


if __name__ == "__main__":
    main()
