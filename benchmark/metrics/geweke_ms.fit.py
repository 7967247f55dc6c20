"""Geweke's checks (`infer.metropolis`, `infer.geweke`): the
`sampler/geweke` spans (the window's read-back and the test), mean ms per
fit."""
from harness.program import has_span, mean_per_request, span_ns


def read(tr):
    return mean_per_request(tr, lambda r: 1e-6 * span_ns(r, "geweke",
                                                         "sampler"),
                            needs=lambda r: has_span(r, "geweke", "sampler"))
