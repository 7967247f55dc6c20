"""Designs (port of `ccgp_tpu/design`): Latin hypercubes, the
maximum-entropy criteria and searches, and k-medoids."""
from ccgp_tpu_torch.design.entropy import augmented_me_criterion, me_criterion
from ccgp_tpu_torch.design.kmedoids import kmedoids
from ccgp_tpu_torch.design.lhs import maximin_lhs, random_lhs
from ccgp_tpu_torch.design.optimize import (
    DesignResult, batch_me_design, me_design)
