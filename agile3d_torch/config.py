"""Configuration of the model, the losses, training and the voxel-count
padding buckets.

Mirrors the JAX package's ``config.py`` for what the eval, serving and
training paths read: among them the decoder's attention policy (dense
attention below a logits volume, the online-softmax chunked forms above
it) and its dtype policy (``decoder_dtype``), the backbone's block type
(``block``: the variant family of ``models/backbone.py``) and the training
loop's prefetch depth. The TPU implementation knobs (scan_blocks,
factored_conv, strip_conv, stem_zdilated) are not fields here: each
selects a TPU layout of the same conv function (a scan over stacked
blocks, two-stage or strip gathers, a z-dilated stem), and the port's convs
are the plain gather-GEMM or the banded CUDA kernels. ``backbone_dtype``
is not ported yet: the backbone runs in float32 outside the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Res16UNet34C by default (reference models/res16unet.py:371-372);
    ``models/backbone.py::backbone_config`` names the other variants."""

    in_channels: int = 3
    init_dim: int = 32
    planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96)
    layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2)
    conv1_kernel_size: int = 5
    bn_momentum: float = 0.02
    block: str = "basic"                # "basic" | "bottleneck"
    # Banded CUDA kernels for the wide k3 convs of the two finest levels and
    # for the k5 stem (ops/banded_conv.py, ops/banded_stem.py). None = on
    # for CUDA tensors; the CPU always takes the plain gather-GEMM.
    banded_conv: bool | None = None

    @property
    def expansion(self) -> int:
        """Output channels of a block over its ``planes``."""
        return 4 if self.block == "bottleneck" else 1


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
    aux: bool = True
    voxel_size: float = 0.05
    backbone: BackboneConfig = dataclasses.field(default_factory=BackboneConfig)
    max_fg_objects: int = 10
    max_clicks: int = 256
    time_table_len: int = 256
    # The decoder's attention policy (the JAX package's xla_attn_chunk and
    # xla_attn_dense_threshold): dense attention while the [B, H, Q, N]
    # logits volume is at most attn_dense_threshold elements, else the
    # online-softmax forms over key / query chunks of the largest
    # power-of-two divisor of N up to attn_chunk, down to 4096, that gives
    # at least 6 chunks (models/agile3d.py::_pick_attn_chunk); 0 = dense.
    attn_chunk: int = 32768
    attn_dense_threshold: int = 10_000_000
    # "bfloat16": decoder weights and the scene's mask features and
    # positional encodings in bf16, promoted to f32 where the JAX package's
    # are; the mask logits stay f32. The serving default (run_ui.py).
    decoder_dtype: str = "float32"


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
    val_batch_size: int = 1
    max_num_clicks: int = 20            # per-object eval click budget
    num_workers: int = 2
    # batches assembled on a host thread ahead of the device step
    # (data/prefetch.py; 0 = synchronous); --num_workers sets it
    prefetch: int = 2


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
