"""BFGS's evaluations replayed as CUDA graphs (`infer.optim._Evaluator`,
every search of a fit: the plug-in's starts and Laplace's):
`bfgs.graph.replays` over `bfgs.evals`, summed over the window's fits, %.
A program that captures no graph counts no `bfgs.graph.*`: nothing to
read there."""
from harness.program import counter, counter_prefixed, ratio


def read(tr):
    return ratio(tr, lambda r: counter(r, "bfgs.graph.replays"),
                 lambda r: counter(r, "bfgs.evals"), 100.0,
                 needs=lambda r: counter_prefixed(r, "bfgs.graph.") > 0)
