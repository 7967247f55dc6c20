"""The composite GP's fit (`models.composite_gp.cgp_fit`: the candidate
batch, the bounded BFGS of the best starts, the jackknife), the span
`study/cgp`, mean ms a study."""
from harness.study_records import mean_span_ms


def read(tr):
    return mean_span_ms(tr, "cgp")
