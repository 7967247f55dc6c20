"""Predictive moments (`predict.posterior.predictive_moments`): the span,
mean ms per query."""
from harness.readers import mean_span_ms


def read(tr):
    return mean_span_ms(tr, "moments")
