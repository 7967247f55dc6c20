"""Host read-backs (`utils.trace.readback`: every bool, int, float and
.cpu() of a device tensor on the study's path, mlegp's and the composite
GP's line searches most of them): `readbacks` counted anywhere in a
`study` record, mean a study."""
from harness.study_records import mean_counter


def read(tr):
    return mean_counter(tr, "readbacks")
