"""Masked normalization (counterpart of the JAX package's ``ops/norm.py``).

Dtypes are JAX's: eval-mode BatchNorm of a bf16 x against f32 running
statistics promotes to f32; training-mode BatchNorm computes the batch
statistics and its output in x's dtype (bf16 for a bf16 x) and the new
running statistics in f32."""

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


def batch_norm_train(x: torch.Tensor, valid: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     momentum: float = 0.02, reduce=None):
    """Training-mode BatchNorm over the valid rows of x [N, C]: batch mean,
    biased variance for the normalisation, unbiased variance for the
    running statistics, ``running = (1 - m) * running + m * batch``; rows
    where ``valid`` is False come out exactly 0. Returns (y, new_mean,
    new_var); the running buffers are not touched (the caller commits the
    new statistics, detached). ``reduce``: the sum over the processes that
    hold the batch's other rows (``parallel/mesh.py::psum`` on their axis),
    applied to the count, the sum and the sum of squares; None when x holds
    every row."""
    reduce = reduce or (lambda t: t)
    m = valid.to(x.dtype)
    n = torch.clamp(reduce(m.sum()), min=1)
    mean = reduce((x * m[:, None]).sum(0)) / n
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    d = torch.where(valid[:, None], x - mean, zero)
    ss = reduce((d * d).sum(0))
    var = ss / n
    var_unbiased = ss / torch.clamp(n - 1, min=1)
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * var_unbiased
    y = (x - mean) * torch.rsqrt(var + EPS)
    y = y * weight + bias
    return torch.where(valid[:, None], y, zero), new_mean, new_var


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """torch nn.LayerNorm over the last axis (biased variance, eps 1e-5)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * weight + bias
