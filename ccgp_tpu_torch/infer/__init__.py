from ccgp_tpu_torch.infer.diagnostics import (
    effective_sample_size, gelman_rubin)
