"""mlegp's ARD fit (`infer.mle.mlegp_fit`: the isotropic grid, 49 serial
BFGS starts, the final fit), the span `study/mlegp`, mean ms a study."""
from harness.study_records import mean_span_ms


def read(tr):
    return mean_span_ms(tr, "mlegp")
