"""Batch axes split over a mesh of devices (port of `ccgp_tpu/parallel`)."""
from ccgp_tpu_torch.parallel.mesh import (
    Mesh, Sharding, data_sharding, make_mesh, replicated)
from ccgp_tpu_torch.parallel.sharded import (
    TrainStepState,
    distributed_train_step,
    multi_chain_metropolis,
    sharded_design_sweep,
    sharded_hyperpar_scan,
    sharded_posterior_predict,
)
