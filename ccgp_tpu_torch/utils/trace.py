"""The port's tracer: spans and counters per request, on the host's clock,
cheap enough to stay on.

    from ccgp_tpu_torch.utils import trace

    with trace.span("laplace"):            # a span, nested by thread
        trace.count("bfgs.evals")          # a counter on the open span
        ok = bool(trace.readback(flag))    # a device-to-host read-back

A span opened while its thread has no span open starts a request record:
`models.combined_gp` opens `fit` and `predict`, so each call of an entry
point is one record. A record is a dict: `id`, `name` (the root's),
`raised`, the root's `start_ns`, `ns` and `child_ns`; `spans`, its spans
by path below the root (`laplace/bfgs`, `sampler/chunk/readback`) as
[count, total ns, children's ns], so a path's self time is total minus
children; and `counts`, its counters by the path of the innermost span
open when they were counted ("" for the root). Finished records go into
a bounded buffer: `requests()` returns it, oldest first, and `last()`
the newest.

Levels (`set_level`): 0 records nothing; 1 (the default) keeps the
records; 2 also keeps one timeline entry per span (`timeline()`). The
environment variable CCGP_TRACE_LEVEL sets the level a process starts at.

The clock is `time.perf_counter_ns()` and no span synchronizes the
device: a span measures the host's timeline, the host's waits on the
device are the `readback` spans, and the device's own time per kernel is
the profiler's. While a torch profiler records, every span also opens
`torch.profiler.record_function("span:" + path)` (the root: "span:" +
its name), so the profile carries the program's spans on its own clock;
`unix_offset_ns()` maps this clock onto the profiler's (Unix) one.

Stacks are per thread: the shards of `parallel.sharded`, each on a host
thread, keep records of their own. A span closed by an exception still
closes, and a root closed so marks its record `raised`.
"""
from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from collections import deque

import torch

# records kept: 2.7x the ~6,000 queries a 51 s window of the benchmark's
# prediction cell serves
CAPACITY = 16384
# level-2 timeline entries kept (~300-500 spans a fit request)
TIMELINE_CAPACITY = 1 << 18

_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class Tracer:
    """Per-thread span stacks, the record buffer and the level-2 timeline.
    The module-level functions below act on one process-wide tracer.
    Read-backs are counted from CUDA tensors, and with `cpu_as_device`
    (for tests on a machine without a card) from CPU ones too."""

    def __init__(self, capacity: int = CAPACITY,
                 timeline_capacity: int = TIMELINE_CAPACITY):
        self.set_level(int(os.environ.get("CCGP_TRACE_LEVEL", "1")))
        self.cpu_as_device = False
        self._local = threading.local()
        self._records = deque(maxlen=capacity)
        self._timeline = deque(maxlen=timeline_capacity)
        self._ids = itertools.count(1)

    def span(self, name: str) -> "_Span":
        """A context manager timing the block as span `name`, or a
        decorator timing each call of a function so."""
        return _Span(self, name)

    def count(self, name: str, k=1) -> None:
        """Add k to counter `name` of the current request, under the path
        of the innermost open span (nothing outside a request)."""
        if self.level <= 0:
            return
        st = getattr(self._local, "stack", None)
        if not st:
            return
        top = st[-1]
        counts = top.rec["counts"]
        c = counts.get(top.path)
        if c is None:
            c = counts[top.path] = {}
        c[name] = c.get(name, 0) + k

    def readback(self, t: torch.Tensor):
        """t on the host: `t.cpu()`, or for a 0-dim tensor its number
        (`t.item()`, one copy less: 5-7 us a read-back on an H100
        machine); for a CUDA tensor, as a `readback` span that counts
        `readbacks`."""
        if self.level <= 0 or not (t.is_cuda or self.cpu_as_device):
            return _host(t)
        st = getattr(self._local, "stack", None)
        if not st:
            with _Span(self, "readback"):
                self.count("readbacks")
                return _host(t)
        # the span inlined: nothing nests inside a read-back
        top = st[-1]
        path = top.rb_path
        if path is None:
            path = top.rb_path = (top.path + "/readback" if top.path
                                  else "readback")
        rf = None
        if _profiling():
            rf = torch.profiler.record_function("span:" + path)
            rf.__enter__()
        t0 = _now()
        try:
            out = _host(t)
        finally:
            t1 = _now()
            if rf is not None:
                rf.__exit__(None, None, None)
            dt = t1 - t0
            rec = top.rec
            agg = rec["spans"].get(path)
            if agg is None:
                agg = rec["spans"][path] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            top.child += dt
            counts = rec["counts"]
            c = counts.get(path)
            if c is None:
                c = counts[path] = {}
            c["readbacks"] = c.get("readbacks", 0) + 1
            if self.level >= 2:
                self._timeline.append(
                    {"request": rec["id"], "span": next(self._ids),
                     "parent": top.sid, "path": path, "start_ns": t0,
                     "end_ns": t1})
        return out

    def set_level(self, level: int) -> None:
        if level not in (0, 1, 2):
            raise ValueError(f"trace level must be 0, 1 or 2, got {level!r}")
        self.level = level

    def requests(self) -> list:
        return list(self._records)

    def last(self):
        return self._records[-1] if self._records else None

    def timeline(self) -> list:
        return list(self._timeline)

    def clear(self) -> None:
        """Drop the kept records and timeline entries."""
        self._records.clear()
        self._timeline.clear()


def _host(t: torch.Tensor):
    return t.item() if t.dim() == 0 else t.cpu()


class _Span:
    __slots__ = ("tr", "name", "path", "rec", "parent", "stack", "sid", "t0",
                 "ns", "child", "rf", "rb_path", "on")

    def __init__(self, tr: Tracer, name: str):
        self.tr, self.name = tr, name

    def __call__(self, fn):
        """As a decorator: each call of fn runs as a span of this name."""
        tr, name = self.tr, self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with _Span(tr, name):
                return fn(*args, **kwargs)
        return spanned

    @property
    def seconds(self) -> float:
        """The span's duration, once it has closed (at every level)."""
        return self.ns * 1e-9

    def __enter__(self):
        tr = self.tr
        level = tr.level
        if level <= 0:
            self.on = False
            self.t0 = _now()
            return self
        self.on = True
        try:
            st = tr._local.stack
        except AttributeError:
            st = tr._local.stack = []
        if st:
            parent = self.parent = st[-1]
            self.rec = parent.rec
            path = parent.path
            self.path = path + "/" + self.name if path else self.name
        else:
            self.parent = None
            self.rec = {"id": next(tr._ids), "name": self.name,
                        "raised": False, "start_ns": 0, "ns": 0,
                        "child_ns": 0, "spans": {}, "counts": {}}
            self.path = ""
        self.stack = st
        self.sid = next(tr._ids) if level >= 2 else None
        self.child = 0
        self.rb_path = None
        if _profiling():
            self.rf = torch.profiler.record_function(
                "span:" + (self.path or self.name))
            self.rf.__enter__()
        else:
            self.rf = None
        st.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        dt = self.ns = t1 - self.t0
        if not self.on:
            return False
        st = self.stack
        if st[-1] is self:
            st.pop()
        else:
            st.remove(self)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        rec, path, parent = self.rec, self.path, self.parent
        if parent is None:
            rec["start_ns"], rec["ns"] = self.t0, dt
            rec["child_ns"] = self.child
            rec["raised"] = exc_type is not None
            self.tr._records.append(rec)
        else:
            spans = rec["spans"]
            agg = spans.get(path)
            if agg is None:
                agg = spans[path] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += self.child
            parent.child += dt
        if self.sid is not None:
            self.tr._timeline.append(
                {"request": rec["id"], "span": self.sid,
                 "parent": None if parent is None else parent.sid,
                 "path": path or self.name, "start_ns": self.t0,
                 "end_ns": t1})
        return False


def unix_offset_ns() -> int:
    """Unix time less `perf_counter_ns`, now: add it to a span's start or
    end to place it on the torch profiler's clock."""
    best = None
    for _ in range(5):
        a = _now()
        u = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
readback = TRACER.readback
set_level = TRACER.set_level
requests = TRACER.requests
last = TRACER.last
timeline = TRACER.timeline
clear = TRACER.clear
