"""mlegp's multistart BFGS: its guarded value-and-gradient evaluations,
`bfgs.evals` under `study/mlegp` summed over the starts, mean a study."""
from harness.study_records import mean_counter


def read(tr):
    return mean_counter(tr, "bfgs.evals", "mlegp")
