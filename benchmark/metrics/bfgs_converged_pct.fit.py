"""BFGS's stops (`infer.optim.minimize_bfgs`, every run of a fit: the
plug-in's starts and Laplace's): `bfgs.stop.converged` over all
`bfgs.stop.*` (converged, line_search, maxiter), summed over the window's
fits, %."""
from harness.program import counter, counter_prefixed, ratio


def read(tr):
    return ratio(tr, lambda r: counter(r, "bfgs.stop.converged"),
                 lambda r: counter_prefixed(r, "bfgs.stop."), 100.0)
