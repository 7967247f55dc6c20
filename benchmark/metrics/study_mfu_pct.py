"""The whole study request: its floating-point operations
(`harness.study_records.study_flops`, from the shapes and the program's
counters) over the requests' seconds times the float64 peak, %."""
from harness.study_records import mfu_pct


def read(tr):
    return mfu_pct(tr)
