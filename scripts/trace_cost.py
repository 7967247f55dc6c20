"""Cost of the tracer on the card's host, and the events a request carries.

    python3 scripts/trace_cost.py [--cells bench2d.n100,gv9d.splits,...]

Prints one JSON object: ns per span, per count and per read-back at levels
0, 1 and 2 and with a torch profiler recording; the bare read-backs
(`bool(t)`, `bool(t.cpu())`); for each cell, the events of its requests at
level 1 (from the records of a few of the cell's own requests) with the
cost they add, the read-backs against the synchronizing operations
`torch.cuda.set_sync_debug_mode` reports, and the request times at levels
0, 1 and 2 in turns."""
import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from ccgp_tpu_torch.utils import trace  # noqa: E402

N = 200_000


def per_call(fn, n=N):
    best = None
    for _ in range(3):
        t0 = time.perf_counter_ns()
        fn(n)
        dt = (time.perf_counter_ns() - t0) / n
        best = dt if best is None else min(best, dt)
    return best


def loop_empty(n):
    for _ in range(n):
        pass


def loop_span(n):
    sp = trace.span
    for _ in range(n):
        with sp("x"):
            pass


def loop_count(n):
    c = trace.count
    for _ in range(n):
        c("x")


def micro(device) -> dict:
    t = torch.zeros((), dtype=torch.bool, device=device)
    if device == "cpu":
        trace.TRACER.cpu_as_device = True

    def loop_readback(n):
        rb = trace.readback
        for _ in range(n):
            rb(t)

    def loop_cpu(n):
        for _ in range(n):
            t.cpu()

    def loop_bool(n):
        for _ in range(n):
            bool(t)

    def loop_bool_cpu(n):
        for _ in range(n):
            bool(t.cpu())

    def loop_bool_readback(n):
        rb = trace.readback
        for _ in range(n):
            bool(rb(t))

    out = {}
    nr = N // 10
    for level in (0, 1, 2):
        trace.set_level(level)
        trace.clear()
        with trace.span("root"):
            base = per_call(loop_empty)
            out[f"level{level}"] = {
                "span_ns": per_call(loop_span) - base,
                "count_ns": per_call(loop_count) - base,
                "readback_over_cpu_ns": (per_call(loop_readback, nr)
                                         - per_call(loop_cpu, nr)),
            }
    trace.set_level(1)
    trace.clear()
    with trace.span("root"):
        out["bare"] = {"bool_ns": per_call(loop_bool, nr),
                       "bool_cpu_ns": per_call(loop_bool_cpu, nr),
                       "bool_readback_ns": per_call(loop_bool_readback, nr)}
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    n = 20_000
    with profile(activities=acts):
        with trace.span("root"):
            base = per_call(loop_empty, n)
            out["level1_profiler_on"] = {
                "span_ns": per_call(loop_span, n) - base,
                "count_ns": per_call(loop_count, n) - base,
                "bool_readback_ns": per_call(loop_bool_readback, n // 10)}
    trace.TRACER.cpu_as_device = False
    trace.clear()
    return out


def events(rec) -> dict:
    """The calls a record took: spans (the root, the spans, the read-backs
    among them) and `count` calls: one a BFGS evaluation, one a BFGS run
    (its stop), one a chunk (`rounds.launched`), one a driver
    (`rounds.kept`)."""
    spans = 1 + sum(a[0] for a in rec["spans"].values())
    readbacks = sum(c.get("readbacks", 0) for c in rec["counts"].values())
    n_of = lambda leaf: sum(a[0] for p, a in rec["spans"].items()  # noqa: E731
                            if p.rsplit("/", 1)[-1] == leaf)
    calls = sum(c.get("bfgs.evals", 0) for c in rec["counts"].values())
    calls += n_of("bfgs") + n_of("chunk") + n_of("sampler")
    return {"spans": spans - readbacks, "readbacks": readbacks,
            "counts": calls}


def cell(name, seed, reps, costs) -> dict:
    from harness import spec
    from harness.cell import Runner

    c = spec.load_cell(name, ROOT)
    runner = Runner(c, seed, "cuda")
    runner.system.load()
    runner.setup()
    runner.warm_up()
    torch.cuda.synchronize()
    # the records of a few requests at level 1
    trace.set_level(1)
    trace.clear()
    root = "fit" if runner.kind == "fit_predict" else "predict"
    n_req = 8 if runner.kind == "fit_predict" else 64
    for i in range(n_req):
        runner.serve(runner.stream.request(i))
    recs = [r for r in trace.requests() if r["name"] == root]
    ev = [events(r) for r in recs]
    mean = {k: statistics.mean(e[k] for e in ev) for k in ev[0]}
    lv1 = costs["level1"]
    add_ns = (mean["spans"] * lv1["span_ns"]
              + mean["readbacks"] * lv1["readback_over_cpu_ns"]
              + mean["counts"] * lv1["count_ns"])
    out = {"requests": len(recs), "events_per_request": mean,
           "level1_added_ms_per_request": add_ns * 1e-6,
           "request_ms_level1": 1e-6 * statistics.mean(r["ns"] for r in recs)}
    # read-backs against the synchronizing operations
    trace.clear()
    torch.cuda.set_sync_debug_mode(1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner.serve(runner.stream.request(n_req))
    torch.cuda.set_sync_debug_mode(0)
    rec = [r for r in trace.requests() if r["name"] == root][-1]
    syncs = {}
    for w in caught:
        msg = str(w.message)
        if "synchroniz" in msg.lower():
            syncs[msg[:80]] = syncs.get(msg[:80], 0) + 1
    out["sync_debug"] = {
        "readbacks": sum(c.get("readbacks", 0)
                         for c in rec["counts"].values()),
        "synchronizing_ops": sum(syncs.values()), "kinds": syncs}
    # request times at each level, in turns
    times = {0: [], 1: [], 2: []}
    for rep in range(reps):
        req = runner.stream.request(1000 + rep)
        for level in (0, 1, 2, 2, 1, 0):
            trace.set_level(level)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.serve(req)
            times[level].append(time.perf_counter() - t0)
    trace.set_level(1)
    trace.clear()
    out["request_ms_by_level"] = {
        str(k): 1e3 * statistics.median(v) for k, v in times.items()}
    out["request_ms_by_level_all"] = {
        str(k): [1e3 * x for x in v] for k, v in times.items()}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="")
    ap.add_argument("--seed", type=int, default=7300000001)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = {"device": (torch.cuda.get_device_name(0) if device == "cuda"
                      else "cpu")}
    if device == "cuda":
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    out["micro"] = micro(device)
    print(json.dumps(out), flush=True)
    for name in filter(None, args.cells.split(",")):
        out[name] = cell(name, args.seed, args.reps, out["micro"])
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
