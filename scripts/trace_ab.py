"""In one process, the same requests served with the tracer reduced to
what the program did before it had one (read-backs straight from the
device tensor, no counts, level 0) and at level 1, in turns; prints the
ratio per cell.

    python3 scripts/trace_ab.py <cell>[,<cell>...] <seed> <requests>
"""
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
from ccgp_tpu_torch.utils import trace  # noqa: E402
from harness import spec  # noqa: E402
from harness.cell import Runner  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
orig = (trace.readback, trace.count)


def mode(m):
    if m == "bare":
        trace.readback = lambda t: t if t.dim() == 0 else t.cpu()
        trace.count = lambda name, k=1: None
        trace.set_level(0)
    else:
        trace.readback, trace.count = orig
        trace.set_level(1)


for name in sys.argv[1].split(","):
    c = spec.load_cell(name, ROOT)
    runner = Runner(c, int(sys.argv[2]), "cuda")
    runner.system.load()
    runner.setup()
    runner.warm_up()
    torch.cuda.synchronize()
    t = {"bare": [], "level1": []}
    ratios = []
    for i in range(int(sys.argv[3])):
        req = runner.stream.request(i)
        got = {}
        for m in (("bare", "level1", "level1", "bare") if i % 2 == 0
                  else ("level1", "bare", "bare", "level1")):
            mode(m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.serve(req)
            got.setdefault(m, []).append(time.perf_counter() - t0)
        for m in got:
            t[m].extend(got[m])
        ratios.append(sum(got["level1"]) / sum(got["bare"]))
    mode("level1")
    print(json.dumps({"cell": name, "bare_ms_median": 1e3 * statistics.median(t["bare"]),
                      "level1_ms_median": 1e3 * statistics.median(t["level1"]),
                      "ratio_median": statistics.median(ratios),
                      "ratios": [round(r, 4) for r in ratios],
                      "level1_slower_in": sum(r > 1 for r in ratios)}), flush=True)
