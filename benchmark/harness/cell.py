"""One run of one cell: set-up, warm-up, the measured closed loop, the
traced part, the correctness check and the result line's fields. The
system under test and its check are the modules the configuration's
"system" names (`systems/<system>.py`, `checks/<system>.py`)."""
from __future__ import annotations

import math
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from harness import check, spec, trace, window
from harness.traffic import Stream

# the warm-up's pool entry: one of the cell's shapes that the window never
# sends (keys fold in a 32-bit index)
WARM_UP = 2 ** 32 - 1


class Runner:
    def __init__(self, cell: spec.Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell.config
        self.sut = spec.load_module("systems", self.cfg["system"])
        self.system = self.sut.System(self.cfg, device)
        self.stream = Stream(self.cfg, cell.traffic, seed, device,
                             self.system.dtype)
        self.kind = self.stream.kind
        self.fit = None
        self.fit_item = None

    def setup(self):
        """The predict cell's emulator, fitted once."""
        if self.kind == "predict":
            d, key = self.stream.fit_design, self.stream.fit_key
            self.fit = self.system.fit(d.x, d.y, key)
            trace.sync(self.device)
            self.fit_item = (d, self.system.fit_out(self.fit, key))

    def serve(self, req):
        """One request, ended by a synchronize; returns (fit, pred)."""
        d = req.design
        fit = (self.system.fit(d.x, d.y, req.key_fit)
               if self.kind == "fit_predict" else self.fit)
        pred = self.system.predict(fit, d.x, req.x_new, req.key_predict)
        trace.sync(self.device)
        return fit, pred

    def warm_up(self):
        if self.kind == "fit_predict":
            self.serve(self.stream.pool_request(WARM_UP, WARM_UP))
            return
        sizes = self.stream.sizes
        for j in (int(np.argmin(sizes)), int(np.argmax(sizes))):
            self.serve(self.stream.query(WARM_UP, j))


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start=None) -> dict:
    """The result line's fields for one run (without the module check)."""
    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_start)]
    runner = Runner(cell, seed, device)
    if on_card:
        runner.system.load()
        marks.append(("kernels loaded", time.perf_counter()))
    marks.append(("inputs", time.perf_counter()))
    spans = trace.Spans(device, runner.sut.SPANS) if traced else None
    if spans:
        spans.install()
    try:
        runner.setup()
        marks.append(("fit of the predict cell", time.perf_counter()))
        runner.warm_up()
        marks.append(("warm-up", time.perf_counter()))
        print("setup: " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=sys.stderr)
        if spans:
            spans.take()
        out = _window(runner, cell, seconds, spans, t_start, on_card)
    finally:
        if spans:
            spans.uninstall()
    return out


class _Served:
    """What the loop keeps of the requests it served: every latency, and
    the answers of a sample of the requests that did not fail, drawn from
    the seed (a reservoir of `check.requests`; for queries also the first
    of the largest size)."""

    def __init__(self, runner, spans):
        self.runner, self.spans = runner, spans
        self.latencies, self.members, self.kept = [], [], {}
        self.failed = 0
        self.size = runner.cell.traffic["check"]["requests"]
        self.rng = np.random.default_rng([runner.seed, 0x636865636B])
        self.seen = 0
        self.largest, self.largest_item = None, None
        if runner.kind == "predict":
            self.largest = int(np.argmax(runner.stream.sizes))

    def _sample(self, i: int) -> bool:
        self.seen += 1
        if len(self.kept) < self.size:
            return True
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            return True
        return False

    def answers(self) -> list:
        out = list(self.kept.values())
        if self.largest_item is not None and not any(
                a is self.largest_item for a in out):
            out.append(self.largest_item)
        return out

    def one(self, i: int):
        """Serve request i; returns its span record in the traced run."""
        runner, system = self.runner, self.runner.system
        req = runner.stream.request(i)
        self.members.append(req.member)
        t = time.perf_counter()
        try:
            fit, pred = runner.serve(req)
        except Exception:      # a request that raises is a failed one
            trace.sync(runner.device)
            self.latencies.append(time.perf_counter() - t)
            self.failed += 1
            traceback.print_exc(file=sys.stderr)
            return None
        lat = time.perf_counter() - t
        self.latencies.append(lat)
        if (torch.device(runner.device).type == "cuda"
                and pred.mean.device.type != "cuda"):
            raise RuntimeError("the program answered off the card")
        fitted = runner.kind == "fit_predict"
        failed = system.failed(fit if fitted else None, pred)
        self.failed += failed
        # a failed request is counted as failed, not compared
        largest = (not failed and req.member == self.largest
                   and self.largest_item is None)
        if (not failed and self._sample(i)) or largest:
            item = (req, system.fit_out(fit, req.key_fit) if fitted
                    else None, system.pred_out(pred))
            if len(self.kept) < self.size:
                self.kept[i] = item
            if largest:
                self.largest_item = item
        if not self.spans:
            return None
        rec = {"seconds": lat, "spans": self.spans.take(),
               "member": req.member, "m": int(req.x_new.shape[0])}
        if fitted:
            rec.update(system.chain(fit))
        return rec


def _window(runner, cell, seconds, spans, t_start, on_card) -> dict:
    """The measured loop; in the traced run with spans, followed by the
    profiled requests of the traffic's `profile`."""
    served = _Served(runner, spans)
    records, profiled, profile = [], [], None
    i = 0
    trace.sync(runner.device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        records.append(served.one(i))
        i += 1
    window_s = time.perf_counter() - t0
    if spans and on_card:
        before = runner.system.launches()
        with trace.Profile() as prof:
            for _ in range(cell.traffic["profile"]["requests"]):
                profiled.append(served.one(i))
                i += 1
        t = time.perf_counter()
        profile = prof.summary()
        after = runner.system.launches()
        profile["launches"] = {k: after[k] - before[k] for k in after}
        print(f"profile: {len(profiled)} requests in {prof.window_s:.3f} s, "
              f"read in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    records = [r for r in records if r is not None]
    profiled = [r for r in profiled if r is not None]
    latencies, failed = served.latencies, served.failed
    print(f"requests: {len(latencies)}; latency ms min / median / max: "
          f"{1e3 * min(latencies):.1f} / "
          f"{1e3 * float(np.median(latencies)):.1f} / "
          f"{1e3 * max(latencies):.1f}", file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    names = [m["name"] for m in (cell.per_layer if spans
                                 else cell.end_to_end)]
    metrics = {}
    if spans:
        tr = SimpleNamespace(requests=records, profiled=profiled,
                             profile=profile, cfg=cell.config,
                             kind=runner.kind)
        for name in names:
            v = spec.metric_reader(name)(tr)
            if v is not None:
                metrics[name] = v
    else:
        for name in names:
            metrics[name] = window.end_to_end(name, window_s, latencies,
                                              setup_s)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {"attempted": i, "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "memory_peak_bytes": memory_peak}
    if profile is not None:
        result["busy_s"] = profile["busy_s"]
        result["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": trace.top(profile["ops"]),
                               "idle_gaps": trace.top(profile["gaps"])}
    del runner.fit
    t = time.perf_counter()
    answers = served.answers()
    result["numbers"] = compare(runner, answers)
    print(f"check: {len(answers)} answers in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return result


def compare(runner, kept, prec=None) -> dict:
    """The correctness numbers over the kept answers (req, fit out, pred
    out), the predict cell's emulator besides: the program's, or with
    `prec` the control's in its place."""
    judge = spec.load_module("checks", runner.cfg["system"]).Check(
        runner.cfg)
    numbers = {}
    fits = [(req.design, fo) for req, fo, _ in kept if fo is not None]
    if runner.fit_item is not None:
        fits.append(runner.fit_item)
    for design, fo in fits:
        check.merge(numbers, judge.fit(design, fo, prec))
    for req, fo, po in kept:
        fo = fo or runner.fit_item[1]
        check.merge(numbers, judge.predict(req.design, req.x_new,
                                           req.key_predict, fo, po, prec))
    return {k: (v if math.isfinite(v) else math.inf)
            for k, v in numbers.items()}
