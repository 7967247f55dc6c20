"""The device: 100 - the busy share of the profiled part of the window,
busy meaning some device operation ran (the profiler's trace)."""
from harness.readers import idle_pct


def read(tr):
    return idle_pct(tr)
