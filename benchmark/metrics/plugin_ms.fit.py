"""Plug-in sigma^2 (`infer.mle`, `infer.optim`): the span around
`kriging_mle_grid` or `kriging_mle`, mean ms per request."""
from harness.readers import mean_span_ms


def read(tr):
    return mean_span_ms(tr, "plugin")
