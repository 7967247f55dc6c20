"""The reference case studies as thin configs over the framework (port of
`ccgp_tpu/experiments`): the four simulation studies and the
batch-sequential maximum-entropy design study. `batch_me_design` reads
the reference's initial design unless its Config regenerates it;
`heat_exchanger`, `ground_vibrations`, `sim_2d_iso_advanced` and
`sim_2d_sweep`, which read the reference's data files, are still to come
(ROADMAP queue 1)."""
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.experiments import (
    batch_me_design,
    sim_1d,
    sim_1d_two_families,
    sim_2d_aniso,
    sim_2d_iso,
)

PORTED = ("sim_1d", "sim_1d_two_families", "sim_2d_iso", "sim_2d_aniso",
          "batch_me_design")
