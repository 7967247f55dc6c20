"""Unconstrained reparameterizations and their log-Jacobians
(port of `ccgp_tpu/utils/transforms.py`).

    log|d theta / d psi| = psi
    log|d p / d phi|     = log sigmoid(phi) + log sigmoid(-phi)

and the tanh box map that turns a box-constrained search into an
unconstrained one (`infer.optim.multistart_minimize`).
"""
from __future__ import annotations

import torch


def sigmoid(phi: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-phi)), the logistic as XLA lowers it. The 1 is a
    tensor on phi's device: PyTorch computes a Python scalar over a tensor
    as a reciprocal times the scalar, and the fused rounds kernel divides.
    It is filled on the device, not copied from the host, so a CUDA graph
    can capture it."""
    one = torch.ones((), dtype=phi.dtype, device=phi.device)
    return one / (1.0 + torch.exp(-phi))


def log_sigmoid(phi: torch.Tensor) -> torch.Tensor:
    """Stable log sigmoid: -(max(-phi, 0) + log1p(exp(-|phi|)))."""
    return -(torch.clamp_min(-phi, 0.0) + torch.log1p(torch.exp(-torch.abs(phi))))


def log_to_positive(psi: torch.Tensor):
    """theta = exp(psi); returns (theta, log_jacobian)."""
    return torch.exp(psi), psi


def logit_to_unit(phi: torch.Tensor):
    """p = sigmoid(phi); returns (p, log_jacobian = log p + log(1 - p))."""
    return sigmoid(phi), log_sigmoid(phi) + log_sigmoid(-phi)


def positive_to_log(theta: torch.Tensor) -> torch.Tensor:
    return torch.log(theta)


def unit_to_logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p) - torch.log1p(-p)


def tanh_box(z: torch.Tensor, lower, upper) -> torch.Tensor:
    """R^k -> (lower, upper)^k: mid + half tanh(z)."""
    mid = 0.5 * (upper + lower)
    half = 0.5 * (upper - lower)
    return mid + half * torch.tanh(z)


def tanh_box_inverse(x: torch.Tensor, lower, upper) -> torch.Tensor:
    mid = 0.5 * (upper + lower)
    half = 0.5 * (upper - lower)
    u = torch.clamp((x - mid) / half, -1.0 + 1e-7, 1.0 - 1e-7)
    return torch.atanh(u)
