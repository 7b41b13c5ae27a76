"""Configuration of the model, the losses, training and the voxel-count
padding buckets.

Mirrors the JAX package's ``config.py`` for what the eval and training
paths read. The
TPU-only conv switches (scan_blocks, factored_conv, strip_conv,
stem_zdilated), the chunked-attention thresholds and the bf16 dtype
policies are not part of this package: convs are the plain gather-GEMM or
the banded CUDA kernels, attention is dense, and everything outside the two
kernels runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Res16UNet34C (reference models/res16unet.py:371-372)."""

    in_channels: int = 3
    init_dim: int = 32
    planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96)
    layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2)
    conv1_kernel_size: int = 5
    bn_momentum: float = 0.02
    # Banded CUDA kernels for the wide k3 convs of the two finest levels and
    # for the k5 stem (ops/banded_conv.py, ops/banded_stem.py). None = on
    # for CUDA tensors; the CPU always takes the plain gather-GEMM.
    banded_conv: bool | None = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Click-as-query decoder (reference models/agile3d.py:399-421)."""

    hidden_dim: int = 128
    dim_feedforward: int = 1024
    num_heads: int = 8
    num_decoders: int = 3
    num_bg_queries: int = 10
    dropout: float = 0.0                # > 0 is not ported yet
    pre_norm: bool = False
    normalize_pos_enc: bool = True
    positional_encoding_type: str = "fourier"
    gauss_scale: float = 1.0
    hlevels: Sequence[int] = (4,)
    shared_decoder: bool = False
    voxel_size: float = 0.05
    backbone: BackboneConfig = dataclasses.field(default_factory=BackboneConfig)
    max_fg_objects: int = 10
    max_clicks: int = 256
    time_table_len: int = 256


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Click-weighted cross-entropy + dice with aux rounds; click weights
    alpha + (beta - alpha) * (1 - min(d, tita) / tita)."""

    losses: Sequence[str] = ("bce", "dice")
    bce_loss_coef: float = 1.0
    dice_loss_coef: float = 2.0
    aux: bool = True
    w_alpha: float = 0.8
    w_beta: float = 2.0
    w_tita: float = 0.3


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    lr_drop: Sequence[int] = (1000,)
    lr_drop_gamma: float = 0.1
    epochs: int = 1100
    val_epochs: int = 50
    batch_size: int = 5
    clip_max_norm: float = 0.1
    seed: int = 42
    max_num_clicks: int = 20            # per-object eval click budget


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    buckets: Sequence[int] = None  # default set in __post_init__

    def __post_init__(self):
        if self.buckets is None:
            object.__setattr__(self, "buckets", DEFAULT_VOXEL_BUCKETS)


# Scenes pad up to the nearest rung. Every rung >= 8192 is a multiple of
# 8192, so padded levels tile evenly into kernel row blocks.
DEFAULT_VOXEL_BUCKETS = (
    2048, 4096, 8192, 16384, 24576, 32768, 49152, 65536, 98304, 131072,
    196608, 262144, 393216, 524288, 786432, 1048576,
)


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_VOXEL_BUCKETS) -> int:
    """Smallest bucket >= n; beyond the ladder, grow in steps of 8192 (or
    of the top rung when it is not a multiple of 8192)."""
    for b in buckets:
        if n <= b:
            return b
    q = 8192 if buckets[-1] % 8192 == 0 else buckets[-1]
    return -(-n // q) * q
