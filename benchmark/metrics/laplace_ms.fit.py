"""Laplace approximation (`infer.laplace`): the span around `laplace`,
mean ms per request."""
from harness.readers import mean_span_ms


def read(tr):
    return mean_span_ms(tr, "laplace")
