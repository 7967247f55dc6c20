"""Rounds the chunked sampler (`infer.metropolis._chunked`) launched past
the chain's end: 100 x (1 - `rounds.kept` / `rounds.launched`), summed
over the window's fits, %."""
from harness.program import counter, ratio


def read(tr):
    return ratio(tr,
                 lambda r: (counter(r, "rounds.launched", "sampler")
                            - counter(r, "rounds.kept", "sampler")),
                 lambda r: counter(r, "rounds.launched", "sampler"), 100.0)
