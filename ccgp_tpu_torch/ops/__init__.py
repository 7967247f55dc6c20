from ccgp_tpu_torch.ops.chol import chol_quadratics
from ccgp_tpu_torch.ops.gram_chol import fused_mix_quadratics
