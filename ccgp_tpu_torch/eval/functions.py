"""Closed-form benchmark functions (port of `ccgp_tpu/eval/functions.py`:
the 1-D set of `1D Codes and Designs/1D Combined GP Public.R:331-339`).

`test_function_1d` keeps the JAX package's name; it is marked so that
pytest never takes it for a test when a test module imports it.
"""
from __future__ import annotations

import torch


def test_function_1d(x: torch.Tensor, code: int) -> torch.Tensor:
    """Function `code` (1-4) of the 1-D study at x (..., n) or (..., n, 1)."""
    x = torch.as_tensor(x)
    if x.ndim > 1 and x.shape[-1] == 1:
        x = x[..., 0]
    if code == 1:
        return 0.5 * torch.sin(10 * x) + 0.5 * torch.cos(15 * x)
    if code == 2:
        return torch.sin(10 * x)
    if code == 3:
        u = 18 * x - 9
        safe = torch.where(u == 0, torch.ones_like(u), u)
        return torch.where(u == 0, torch.ones_like(u), torch.sin(u) / safe)
    if code == 4:
        return torch.exp(3 * x) * torch.cos(5 * (x - 2))
    raise ValueError(f"unknown 1-D function code {code}")


test_function_1d.__test__ = False
