"""The intervals' normal draws (`rng.normal` in
`predict.posterior.posterior_predict`, the plain threefry): the
`intervals/draws` span, mean ms per query."""
from harness.program import has_span, mean_per_request, span_ns


def read(tr):
    return mean_per_request(tr, lambda r: 1e-6 * span_ns(r, "draws",
                                                         "intervals"),
                            needs=lambda r: has_span(r, "draws", "intervals"))
