"""The reference case studies as thin configs over the framework (port of
`ccgp_tpu/experiments`): the four simulation studies, the batch-sequential
maximum-entropy design study and the three studies on the reference's data
(`ground_vibrations`, `heat_exchanger`, `sim_2d_iso_advanced`), which, like
`batch_me_design`'s default Config, read their files under the data root
(`eval.datasets`, CCGP_DATA_ROOT), and `sim_2d_sweep`, the sweep over
the reference's 100 training designs (every design a lane of the
lane-batched K = 1 sampler), which reads the Train_Designs there."""
from ccgp_tpu_torch.experiments.common import StudyResult, run_study
from ccgp_tpu_torch.experiments import (
    batch_me_design,
    ground_vibrations,
    heat_exchanger,
    sim_1d,
    sim_1d_two_families,
    sim_2d_aniso,
    sim_2d_iso,
    sim_2d_iso_advanced,
    sim_2d_sweep,
)

PORTED = ("sim_1d", "sim_1d_two_families", "sim_2d_iso", "sim_2d_aniso",
          "batch_me_design", "ground_vibrations", "heat_exchanger",
          "sim_2d_iso_advanced", "sim_2d_sweep")
