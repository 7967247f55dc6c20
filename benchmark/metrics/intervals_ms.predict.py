"""MC intervals (`predict.posterior.posterior_predict`): the span, mean
ms per query."""
from harness.readers import mean_span_ms


def read(tr):
    return mean_span_ms(tr, "intervals")
