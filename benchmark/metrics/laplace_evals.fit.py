"""Laplace's BFGS (`infer.laplace`, `infer.optim.minimize_bfgs`): its
guarded value-and-gradient evaluations, `bfgs.evals` under `laplace`,
mean per fit."""
from harness.program import counter, has_span, mean_per_request


def read(tr):
    return mean_per_request(tr, lambda r: counter(r, "bfgs.evals", "laplace"),
                            needs=lambda r: has_span(r, "bfgs", "laplace"))
