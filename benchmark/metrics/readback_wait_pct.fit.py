"""The host's wait on the device: the `readback` spans' time over the
`fit` spans' time, summed over the window's fits, %. High means the fit
waits on the card; low, that the host's own work sets its time."""
from harness.program import has_span, ratio, span_ns


def read(tr):
    return ratio(tr, lambda r: span_ns(r, "readback"), lambda r: r["ns"],
                 100.0, needs=lambda r: has_span(r, "readback"))
