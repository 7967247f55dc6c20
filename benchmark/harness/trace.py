"""The traced run's sources: spans around the port's layers, the device
profile of a short steady part of the window, and its breakdown.

Spans wrap the functions a system module lists in its `SPANS` under the
names their calling module binds, in the traced run only. Each synchronizes the device at its start
and its end, so it holds its own device work and nothing queued before
it, and opens a `record_function` range the profile's idle gaps are
labelled by."""
from __future__ import annotations

import importlib
import time
from collections import defaultdict

import torch

def sync(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Per-request span seconds by name, while installed."""

    def __init__(self, device, spans: dict):
        self.device, self.spans = device, spans
        self.current = defaultdict(float)
        self._saved = []

    def _wrap(self, name, fn):
        def span(*args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"span:{name}"):
                out = fn(*args, **kwargs)
                sync(self.device)
            self.current[name] += time.perf_counter() - t0
            return out
        return span

    def install(self):
        for (mod, attr), name in self.spans.items():
            m = importlib.import_module(mod)
            fn = getattr(m, attr)
            self._saved.append((m, attr, fn))
            setattr(m, attr, self._wrap(name, fn))

    def uninstall(self):
        for m, attr, fn in reversed(self._saved):
            setattr(m, attr, fn)
        self._saved.clear()

    def take(self) -> dict:
        out, self.current = dict(self.current), defaultdict(float)
        return out


def _pad():
    """Spin kernels at both ends of a profiled window: without them the
    profiler loses the first or last records of a timing loop."""
    torch.cuda.synchronize()
    for _ in range(4):
        torch.cuda._sleep(20000)
    torch.cuda.synchronize()


class Profile:
    """torch.profiler over a part of the window (CUDA only)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            acc_events=True)

    def __enter__(self):
        self.prof.__enter__()
        _pad()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        _pad()
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """Device operations and busy time inside the window, and the
        host's state in the idle gaps between them."""
        dev, cpu = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the spans' ranges show on the device timeline too
                if not e.name.startswith(("span:", "ProfilerStep")) and (
                        "spin_kernel" not in e.name):
                    dev.append((tr.start, tr.end, e.name))
            else:
                cpu.append((tr.start, tr.end, e.name))
        dev.sort()
        ops = defaultdict(float)
        for s, t, name in dev:
            ops[name] += (t - s) * 1e-6
        busy, gaps = 0.0, []
        if dev:
            cur_s, cur_t = dev[0][0], dev[0][1]
            for s, t, _ in dev[1:]:
                if s > cur_t:
                    busy += cur_t - cur_s
                    gaps.append((cur_t, s))
                    cur_s, cur_t = s, t
                else:
                    cur_t = max(cur_t, t)
            busy += cur_t - cur_s
        return {"window_s": self.window_s, "busy_s": busy * 1e-6,
                "ops": dict(ops), "gaps": _label_gaps(gaps, cpu)}


def _label_gaps(gaps, cpu) -> dict:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost span and the outermost operator running then."""
    events = sorted(cpu)
    out = defaultdict(float)
    stack, i = [], 0
    for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + t)
        while i < len(events) and events[i][0] <= mid:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        spans = [n for _, _, n in stack if n.startswith("span:")]
        ops = [n for _, _, n in stack if not n.startswith("span:")]
        label = spans[-1][5:] if spans else "outside spans"
        out[f"{label}: {ops[0] if ops else 'python'}"] += (t - s) * 1e-6
    return dict(out)


def top(d: dict, k: int = 10) -> list:
    return [[name, v] for name, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:k]]
