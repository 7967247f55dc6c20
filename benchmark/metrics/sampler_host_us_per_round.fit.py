"""The sampler's host side (`infer.metropolis`, the chunked rounds and
Geweke): the `sampler` span less its `readback` spans, over the rounds it
kept (`rounds.kept`, whose sum is the chain's `n_rounds`), summed over
the window's fits, us per round."""
from harness.program import counter, ratio, span_ns


def read(tr):
    return ratio(tr,
                 lambda r: (span_ns(r, "sampler")
                            - span_ns(r, "readback", "sampler")),
                 lambda r: counter(r, "rounds.kept", "sampler"), 1e-3)
