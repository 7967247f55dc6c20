from ccgp_tpu_torch.eb.halton import halton
from ccgp_tpu_torch.eb.hyperpriors import (
    HyperparChoice,
    choose_hyperpars,
    marginal_likelihood,
)
