"""The whole prediction query: the algorithm's floating-point
operations (`harness.readers.request_flops`) over the requests' time
times the dtype's peak, %."""
from harness.readers import mfu_pct


def read(tr):
    return mfu_pct(tr)
