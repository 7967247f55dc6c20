"""The device an entry point runs on.

The port's entry points (`ops.rng.PRNGKey`, the `models.convert`
functions, `fit_combined_gp`, `predict_combined_gp`, `eb.choose_hyperpars`)
take `device="cuda"` by default and move their inputs there: they run on
the GPU unless the caller asks for the CPU with `device="cpu"`. Without a
CUDA device the default raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device(device), raising when it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return dev


def move(obj, dev: torch.device):
    """A tensor, or a NamedTuple holding tensors (recursively), on dev;
    anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(move(v, dev) for v in obj))
    return obj
