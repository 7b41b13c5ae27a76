"""Masked normalization (counterpart of the JAX package's ``ops/norm.py``)."""

from __future__ import annotations

import torch

EPS = 1e-5  # torch BatchNorm / LayerNorm default


def batch_norm(x: torch.Tensor, valid: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm over the rows of x [N, C] with running stats;
    rows where ``valid`` is False come out exactly 0 (zero-pad invariant)."""
    y = (x - running_mean) * torch.rsqrt(running_var + EPS)
    y = y * weight + bias
    return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                      device=y.device))


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """torch nn.LayerNorm over the last axis (biased variance, eps 1e-5)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * weight + bias
