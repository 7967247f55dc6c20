"""Host read-backs (`utils.trace.readback`: every bool, int, float and
.cpu() of a device tensor on the fit's path): `readbacks` counted in a
`fit` record, mean per fit over the window's fits."""
from harness.program import counter, mean_per_request


def read(tr):
    return mean_per_request(tr, lambda r: counter(r, "readbacks"),
                            needs=lambda r: counter(r, "readbacks") > 0)
