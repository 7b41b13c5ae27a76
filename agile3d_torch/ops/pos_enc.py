"""Positional encodings: Gaussian-Fourier, sine and the 1D click-order table
(counterpart of the JAX package's ``ops/pos_enc.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch


def shift_scale_points(xyz, src_min, src_max):
    """Normalize coordinates to [0, 1] per axis over the sample's range."""
    diff = src_max - src_min
    diff = torch.where(diff == 0, torch.ones_like(diff), diff)
    return (xyz - src_min) / diff


def fourier_pos(xyz, gauss_b, src_min=None, src_max=None, *, normalize=True):
    """xyz [..., 3]; gauss_b [3, d_pos//2] -> [..., d_pos] = [sin | cos]."""
    if normalize:
        xyz = shift_scale_points(xyz, src_min, src_max)
    proj = (xyz * (2 * np.pi)) @ gauss_b
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def sine_pos(xyz, d_pos, src_min=None, src_max=None, *, normalize=True,
             temperature=10000.0, scale=2 * math.pi):
    """Per-axis sine embedding; d_pos is split across the 3 axes in even
    chunks with the remainder given two at a time to the leading axes."""
    if normalize:
        xyz = shift_scale_points(xyz, src_min, src_max)
    ndim = d_pos // 3
    if ndim % 2 != 0:
        ndim -= 1
    rems = d_pos - ndim * 3

    embeds = []
    for d in range(3):
        cdim = ndim
        if rems > 0:
            cdim += 2
            rems -= 2
        dim_t = torch.arange(cdim, dtype=torch.float32, device=xyz.device)
        dim_t = temperature ** (2 * torch.floor(dim_t / 2) / cdim)
        pos = xyz[..., d] * scale
        pos = pos[..., None] / dim_t
        sin = torch.sin(pos[..., 0::2])
        cos = torch.cos(pos[..., 1::2])
        embeds.append(torch.stack([sin, cos], dim=-1).reshape(
            *pos.shape[:-1], cdim))
    return torch.cat(embeds, dim=-1)


def positional_encoding_1d(d_model: int, length: int) -> np.ndarray:
    """Click-order table: pe[t, 0::2] = sin(t w), pe[t, 1::2] = cos(t w)."""
    if d_model % 2 != 0:
        raise ValueError(f"d_model must be even, got {d_model}")
    pe = np.zeros((length, d_model), dtype=np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe
