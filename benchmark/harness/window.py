"""Statistics of a measured window: a rate is all the window's time over
all the requests completed in it, and a percentile is taken over the
latency of every request in the window (type 7, linear between order
statistics)."""
from __future__ import annotations

import math
import re

_PCT = re.compile(r"_p(\d+)_ms$")


def percentile(values, q: float) -> float:
    xs = sorted(values)
    if not xs:
        return math.nan
    h = (len(xs) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def mean_ms(window_s: float, completed: int) -> float:
    return 1e3 * window_s / completed if completed else math.nan


def end_to_end(name: str, window_s: float, latencies, setup_s: float):
    """An end-to-end metric by its name: `setup_s`; `<what>_p<NN>_ms`, the
    NN-th percentile of the latencies in ms; `<what>_ms`, the window's
    time per completed request in ms."""
    if name == "setup_s":
        return setup_s
    m = _PCT.search(name)
    if m:
        return 1e3 * percentile(latencies, float(m.group(1)))
    if name.endswith("_ms"):
        return mean_ms(window_s, len(latencies))
    raise ValueError(f"no rule for the end-to-end metric {name!r}")
