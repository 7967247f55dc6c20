"""The plug-in's multistart BFGS (`infer.mle.kriging_mle`): its guarded
value-and-gradient evaluations, `bfgs.evals` under `plugin` summed over
the starts, mean per fit. The grid plug-in runs no BFGS: nothing to
read there."""
from harness.program import counter, has_span, mean_per_request


def read(tr):
    return mean_per_request(tr, lambda r: counter(r, "bfgs.evals", "plugin"),
                            needs=lambda r: has_span(r, "bfgs", "plugin"))
