"""Where the tracer's level-2 entries sit against their `span:` ranges
under torch.profiler, signed (a start after its range's start and an end
before its range's end are inside), for five profiled fits of the card
test's fit: three recording CPU and CUDA activity, two CPU alone. Prints
one JSON line a fit: the medians, the nearest entry to each end, how
many sit outside by more than 5 us and how many more than 50 us off.

    python3 scripts/trace_clock.py
"""
import gc
import json
import statistics
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_cuda as cards  # noqa: E402
from ccgp_tpu_torch.utils import trace  # noqa: E402

DEVICE = torch.device("cuda")


def profiled_fit(activities):
    """The fit's timeline entries and the profile's `span:` ranges, both
    on the profiler's Unix clock, as {path: [(start_ns, end_ns)]}."""
    trace.set_level(2)
    trace.clear()
    gc.collect()
    gc.disable()
    try:
        with profile(activities=activities) as prof:
            for _ in range(3):
                with torch.profiler.record_function("warm-up"):
                    torch.cuda.synchronize()
            cards._trace_fit(DEVICE)
            torch.cuda.synchronize()
        offset = trace.unix_offset_ns()
        timeline = trace.timeline()
    finally:
        gc.enable()
        trace.set_level(1)
        trace.clear()
    base = prof.profiler.kineto_results.trace_start_ns()
    ranges, entries = {}, {}
    for e in prof.events():
        if (e.name.startswith("span:")
                and e.device_type == torch.autograd.DeviceType.CPU):
            ranges.setdefault(e.name[5:], []).append(
                (base + 1000 * e.time_range.start,
                 base + 1000 * e.time_range.end))
    for e in timeline:
        entries.setdefault(e["path"], []).append(
            (e["start_ns"] + offset, e["end_ns"] + offset))
    return entries, ranges


def placement(entries, ranges) -> dict:
    starts, ends, labels = [], [], []
    for label, ents in entries.items():
        got = sorted(ranges.get(label, []))
        if len(got) != len(ents):
            print("count mismatch", label, len(got), len(ents), flush=True)
            continue
        for (s, t), (rs, rt) in zip(sorted(ents), got):
            starts.append(s - rs)
            ends.append(t - rt)
            labels.append(label)
    far = [(round(a / 1e3, 1), round(b / 1e3, 1), label)
           for a, b, label in zip(starts, ends, labels)
           if max(abs(a), abs(b)) > 50_000]
    return {"n": len(starts),
            "start_median_us": statistics.median(starts) / 1e3,
            "end_median_us": statistics.median(ends) / 1e3,
            "start_min_us": min(starts) / 1e3,
            "end_max_us": max(ends) / 1e3,
            "outside_5us": sum(a < -5000 or b > 5000
                               for a, b in zip(starts, ends)),
            "over_50us": len(far), "far": far[:20]}


def main():
    cards._trace_fit(DEVICE)             # kernels loaded, caches warm
    torch.cuda.synchronize()
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, acts in ((("cpu+cuda", both),) * 3
                       + (("cpu", [ProfilerActivity.CPU]),) * 2):
        print(json.dumps({"activities": name,
                          **placement(*profiled_fit(acts))}), flush=True)


if __name__ == "__main__":
    main()
