"""The readings a cell's correctness limits are set from, in one process
on the card (the benchmark's own runs never run this):

    python3 benchmark/harness/readings.py --workload <name> \
        --seeds 1,2,... [--control-seeds 7,8,9] [--fault <name>] \
        [--requests <n>]

For each seed, requests like those the check samples in a run (the fit
pool's first `check.requests` entries, the pool drawn from the seed, of
which those that do not fail; for queries every pool size) are served through the timed path and compared by `harness.cell.compare`
with the float64 reference: the program's readings, whose largest per
number is the lower one. For each control seed, the reference in the
precision below the configuration's (`check.control_precision`) takes the
program's place and is judged the same way: the control's readings. With
--fault, a fault of `faults/<system>.py` is planted in the program for
every seed: the fault's readings. The smallest of a control's or a
fault's readings is an upper one. Prints one JSON line per seed and side,
then the lower and upper readings.
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parents[2])]

import torch  # noqa: E402

from harness import check, spec  # noqa: E402
from harness.cell import Runner, compare  # noqa: E402


def answers(runner) -> list:
    """(request, fit out, pred out) for the requests a run would check."""
    stream, system, out = runner.stream, runner.system, []
    if runner.kind == "fit_predict":
        reqs = [stream.pool_request(i, i)
                for i in range(runner.cell.traffic["check"]["requests"])]
    else:
        reqs = [stream.query(j, j) for j in range(stream.members)]
    for req in reqs:
        fit, pred = runner.serve(req)
        fitted = runner.kind == "fit_predict"
        if system.failed(fit if fitted else None, pred):
            print(f"request {req.index} failed: not compared",
                  file=sys.stderr)
            continue
        fo = system.fit_out(fit, req.key_fit) if fitted else None
        out.append((req, fo, system.pred_out(pred)))
        del fit, pred
    return out


def readings(cell, seed, device, control: bool, fault=None) -> dict:
    if cell.traffic["kind"] == "fit_predict":
        cell.traffic = dict(cell.traffic, pool_seed=int(seed))
    runner = Runner(cell, seed, device)
    if fault:
        planted = spec.load_module("faults", cell.config["system"]).plant
        with planted(fault):
            runner.setup()
            got = answers(runner)
    else:
        runner.setup()
        got = answers(runner)
    prec = check.control_precision(cell.config)
    return {"program": compare(runner, got),
            "control": compare(runner, got, prec) if control else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--requests", type=int, default=None,
                    help="fit requests per seed (default: check.requests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    side = f"fault:{args.fault}" if args.fault else "program"
    lower, upper = {}, {}
    for seed in seeds + [s for s in cseeds if s not in seeds]:
        cell = spec.load_cell(args.workload)
        if args.requests:
            cell.traffic["check"] = dict(requests=args.requests)
        t = time.perf_counter()
        r = readings(cell, seed, args.device, seed in cseeds, args.fault)
        secs = time.perf_counter() - t
        for name, got in ((side, r["program"]), ("control", r["control"])):
            if got is None:
                continue
            print(json.dumps({"seed": seed, "side": name,
                              "seconds": round(secs, 3), **{
                                  k: (v if math.isfinite(v) else "inf")
                                  for k, v in got.items()}}), flush=True)
        for k, v in r["program"].items():
            if args.fault:
                upper[k] = min(upper.get(k, math.inf), v)
            else:
                lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (r["control"] or {}).items():
            upper[k] = min(upper.get(k, math.inf), v)
    print(json.dumps({"lower": lower,
                      "upper": {k: (v if math.isfinite(v) else "inf")
                                for k, v in upper.items()}}))


if __name__ == "__main__":
    main()
