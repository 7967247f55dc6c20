"""The reference case studies as thin configs over the framework (port of
`ccgp_tpu/experiments`): the four that need no data file. `heat_exchanger`,
`ground_vibrations`, `sim_2d_iso_advanced` and `sim_2d_sweep` read the
reference's data files and `batch_me_design` waits for the design
optimizers (ROADMAP queue 1)."""
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.experiments import (
    sim_1d,
    sim_1d_two_families,
    sim_2d_aniso,
    sim_2d_iso,
)

PORTED = ("sim_1d", "sim_1d_two_families", "sim_2d_iso", "sim_2d_aniso")
