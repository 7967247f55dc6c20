"""Closed-form benchmark functions (port of `ccgp_tpu/eval/functions.py`):
the 1-D set of `1D Codes and Designs/1D Combined GP Public.R:331-339`, the
2-D set of `2D Codes and Designs/2D Combined GP Isotropic Public.R:329-341`
and the batch-design pair (on [-1, 1]^2) of `Batch Sequential ME
Designs/Batch Sequential ME Design.R:329-337`.

The functions keep the JAX package's names; they are marked so that
pytest never takes them for tests when a test module imports them.
"""

from __future__ import annotations

import math

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
        return _sinc(18 * x - 9)
    if code == 4:
        return torch.exp(3 * x) * torch.cos(5 * (x - 2))
    raise ValueError(f"unknown 1-D function code {code}")


def _sinc(u: torch.Tensor) -> torch.Tensor:
    safe = torch.where(u == 0, torch.ones_like(u), u)
    return torch.where(u == 0, torch.ones_like(u), torch.sin(u) / safe)


def test_function_2d(xy: torch.Tensor, code: int) -> torch.Tensor:
    """Function `code` (1-5) of the 2-D studies at xy (..., 2)."""
    xy = torch.as_tensor(xy)
    x, y = xy[..., 0], xy[..., 1]
    if code == 1:
        return (torch.exp(-1.4 * x) * torch.cos(7 * math.pi * x * y / 2)
                + torch.log(x + y + 0.1))
    if code == 2:
        return (((x - 0.2) ** 2 - (y - 0.7) ** 2)
                * torch.exp(-5 * ((x - 0.8) ** 2 + (y - 0.1) ** 2))
                * torch.cos(10 * (x - 0.5) * y))
    if code == 3:
        return (((x - 0.5) ** 2 + 4 * (y - 0.8) ** 2)
                * (torch.cos(math.pi * (x - 0.1))
                   + torch.cos(math.pi * (y - 0.5))))
    if code == 4:
        return ((torch.sin(2 * x) + torch.cos(4 * x))
                * (torch.sin(8 * y) + torch.cos(4 * y)))
    if code == 5:
        return _sinc(9 * x - 4.5) * _sinc(12 * y - 6)
    raise ValueError(f"unknown 2-D function code {code}")


def test_function_batch(xy: torch.Tensor, code: int) -> torch.Tensor:
    """The batch-sequential design study's pair (defined on [-1, 1]^2)."""
    if code == 1:
        return test_function_2d(xy, 2)
    if code == 2:
        return test_function_2d(xy, 3)
    raise ValueError(f"unknown batch function code {code}")


for _f in (test_function_1d, test_function_2d, test_function_batch):
    _f.__test__ = False
