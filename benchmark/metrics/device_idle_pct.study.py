"""The device under a study: 100 - the busy share of the profiled study,
busy meaning some device operation ran (the profiler's trace)."""
from harness.readers import idle_pct


def read(tr):
    return idle_pct(tr)
