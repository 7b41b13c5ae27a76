"""The Res16UNet family of sparse-voxel UNets, eval and training mode
(counterpart of the JAX package's ``models/backbone.py``).

  stem conv k=5 at stride 1 -> 4 down stages (k=2 s=2 conv + blocks)
  -> 4 up stages (k=2 s=2 transposed conv + skip concat + blocks),
  emitting 5 feature maps at strides 16/8/4/2/1.

The variants differ in (block, layers, planes) only: ``BACKBONE_VARIANTS``
holds the reference's 20 (reference res16unet.py:298-423), Res16UNet34C the
default. ``BasicBlock`` is two k3 convs; ``Bottleneck`` is 1x1 -> k3 ->
1x1 with 4x expansion, so every stage's output and every skip carry
``planes * expansion`` channels.

Module and parameter names are the reference's (conv0p1s1, bn0, block1,
..., convtr7p2s2, block8; ``.kernel`` for sparse-conv weights, ``.bn`` under
each BatchNorm), so reference state dicts map onto this module key for key
(utils/ckpt.py). Conv kernels are held in ``kernel_offsets`` order.

Routing of the CUDA kernels mirrors the JAX package on the TPU:
  * k3 convs at pyramid levels 0 and 1 with >= 32768 padded rows and
    cin >= 86 (where the TPU's packed strips lose: 3 * cin * 2 B > 512 B)
    go to ``ops.banded_conv``, conv by conv -- block7 and block8 of
    Res16UNet34C (128 -> 96, 96 -> 96), 416 -> 384 and 384 -> 384 in
    Res16UNet14D and 18D, the Bottleneck's middle 256 -> 256 in
    Res16UNet50 and 101, only the 96 -> 64 first convs in Res16UNet34A;
  * the k5 stem at level 0 with >= 32768 padded rows goes to
    ``ops.banded_stem`` in eval only: it has no backward kernel, so
    training takes the plain conv for the stem, as the JAX package does;
  * every other conv is the plain float32 gather-GEMM.

Training mode (``bn_stats`` given): BatchNorm normalises with the batch's
statistics and writes each layer's new running statistics into
``bn_stats``; ``commit_bn_stats`` copies them into the buffers. The k3
routing is the eval rule in training too, through ``BandedConv`` (dX on
the forward kernel, dW on its own kernel). The JAX package's training cap
on banded levels (``AGILE3D_BANDED_TRAIN_MAX``, 262,144 rows) is not
carried over: it was the 15.75 GB HBM limit of a TPU v5e, and the H100 has
80 GB. No per-block rematerialisation: the backward keeps each block's
activations (the 524,288-row training bucket fits on the card), and the
kernels then launch once per forward conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from agile3d_torch.config import BackboneConfig
from agile3d_torch.ops.banded_conv import BandedConv
from agile3d_torch.ops.banded_stem import banded_stem_conv
from agile3d_torch.ops.norm import batch_norm, batch_norm_train
from agile3d_torch.ops.sparse_conv import linear, sparse_conv, sparse_conv_transpose
from agile3d_torch.sparse.grid import PaddedPyramid

BANDED_MIN_ROWS = 32768
BANDED_LEVELS = 2
BANDED_MIN_CIN = 86


class SparseConv(nn.Module):
    """Sparse-conv weight: ``kernel`` [K, cin, cout], or [cin, cout] for a
    1x1 conv."""

    def __init__(self, k_vol: int, cin: int, cout: int):
        super().__init__()
        shape = (k_vol, cin, cout) if k_vol > 1 else (cin, cout)
        self.kernel = nn.Parameter(torch.empty(shape))


class _BNStats(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class BatchNorm(nn.Module):
    """Masked BatchNorm; statistics live under ``.bn`` as in the
    reference's MinkowskiBatchNorm. With ``bn_stats`` (a dict) it takes
    the batch's statistics and records the new running ones there."""

    def __init__(self, c: int, momentum: float):
        super().__init__()
        self.bn = _BNStats(c)
        self.momentum = momentum

    def forward(self, x, valid, bn_stats=None):
        s = self.bn
        if bn_stats is None:
            return batch_norm(x, valid, s.weight, s.bias, s.running_mean,
                              s.running_var)
        y, mean, var = batch_norm_train(x, valid, s.weight, s.bias,
                                        s.running_mean, s.running_var,
                                        self.momentum)
        bn_stats[s] = (mean, var)
        return y


@torch.no_grad()
def commit_bn_stats(bn_stats: dict) -> None:
    """Copy the running statistics a training forward recorded into the
    BatchNorm buffers."""
    for s, (mean, var) in bn_stats.items():
        s.running_mean.copy_(mean)
        s.running_var.copy_(var)


class BasicBlock(nn.Module):
    """conv k3 -> BN -> relu -> conv k3 -> BN (+ 1x1 downsample when
    cin != planes) -> add residual -> relu."""

    def __init__(self, cin: int, planes: int, momentum: float):
        super().__init__()
        self.conv1 = SparseConv(27, cin, planes)
        self.norm1 = BatchNorm(planes, momentum)
        self.conv2 = SparseConv(27, planes, planes)
        self.norm2 = BatchNorm(planes, momentum)
        self.downsample = (nn.Sequential(SparseConv(1, cin, planes),
                                         BatchNorm(planes, momentum))
                           if cin != planes else None)

    def forward(self, x, k3, valid, banded: bool, bn_stats=None):
        conv3 = _conv3_banded if banded else sparse_conv
        out = torch.relu(self.norm1(conv3(x, k3, self.conv1.kernel), valid,
                                    bn_stats))
        out = self.norm2(conv3(out, k3, self.conv2.kernel), valid, bn_stats)
        if self.downsample is not None:
            residual = self.downsample[1](
                linear(x, self.downsample[0].kernel), valid, bn_stats)
        else:
            residual = x
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """conv 1x1 -> BN -> relu -> conv k3 -> BN -> relu -> conv 1x1 to
    planes * 4 -> BN (+ 1x1 downsample when cin != planes * 4) -> add
    residual -> relu (reference resnet_block.py:79-137)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, momentum: float):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SparseConv(1, cin, planes)
        self.norm1 = BatchNorm(planes, momentum)
        self.conv2 = SparseConv(27, planes, planes)
        self.norm2 = BatchNorm(planes, momentum)
        self.conv3 = SparseConv(1, planes, out)
        self.norm3 = BatchNorm(out, momentum)
        self.downsample = (nn.Sequential(SparseConv(1, cin, out),
                                         BatchNorm(out, momentum))
                           if cin != out else None)

    def forward(self, x, k3, valid, banded: bool, bn_stats=None):
        conv3 = _conv3_banded if banded else sparse_conv
        out = torch.relu(self.norm1(linear(x, self.conv1.kernel), valid,
                                    bn_stats))
        out = torch.relu(self.norm2(conv3(out, k3, self.conv2.kernel), valid,
                                    bn_stats))
        out = self.norm3(linear(out, self.conv3.kernel), valid, bn_stats)
        if self.downsample is not None:
            residual = self.downsample[1](
                linear(x, self.downsample[0].kernel), valid, bn_stats)
        else:
            residual = x
        return torch.relu(out + residual)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def _conv3_banded(x, k3, w):
    if x.shape[1] >= BANDED_MIN_CIN:
        return BandedConv.apply(x, k3, w)
    return sparse_conv(x, k3, w)


def _variant(layers, planes, block="basic"):
    return BackboneConfig(layers=tuple(layers), planes=tuple(planes),
                          block=block)


_L14 = (1, 1, 1, 1, 1, 1, 1, 1)
_L18 = (2, 2, 2, 2, 2, 2, 2, 2)
_L34 = (2, 3, 4, 6, 2, 2, 2, 2)
_P_BASE = (32, 64, 128, 256, 256, 256, 256, 256)

# the reference's variants (reference res16unet.py:298-423)
BACKBONE_VARIANTS = {
    "Res16UNet14": _variant(_L14, _P_BASE),
    "Res16UNet18": _variant(_L18, _P_BASE),
    "Res16UNet34": _variant(_L34, _P_BASE),
    "Res16UNet50": _variant(_L34, _P_BASE, block="bottleneck"),
    "Res16UNet101": _variant((2, 3, 4, 23, 2, 2, 2, 2), _P_BASE,
                             block="bottleneck"),
    "Res16UNet14A": _variant(_L14, (32, 64, 128, 256, 128, 128, 96, 96)),
    "Res16UNet14A2": _variant((1, 1, 1, 1, 2, 2, 2, 2),
                              (32, 64, 128, 256, 128, 128, 96, 96)),
    "Res16UNet14B": _variant(_L14, (32, 64, 128, 256, 128, 128, 128, 128)),
    "Res16UNet14B2": _variant((1, 1, 1, 1, 2, 2, 2, 2),
                              (32, 64, 128, 256, 128, 128, 128, 128)),
    "Res16UNet14B3": _variant((2, 2, 2, 2, 1, 1, 1, 1),
                              (32, 64, 128, 256, 128, 128, 128, 128)),
    "Res16UNet14C": _variant(_L14, (32, 64, 128, 256, 192, 192, 128, 128)),
    "Res16UNet14D": _variant(_L14, (32, 64, 128, 256, 384, 384, 384, 384)),
    "Res16UNet18A": _variant(_L18, (32, 64, 128, 256, 128, 128, 96, 96)),
    "Res16UNet18B": _variant(_L18, (32, 64, 128, 256, 128, 128, 128, 128)),
    "Res16UNet18D": _variant(_L18, (32, 64, 128, 256, 384, 384, 384, 384)),
    "Res16UNet34A": _variant(_L34, (32, 64, 128, 256, 256, 128, 64, 64)),
    "Res16UNet34B": _variant(_L34, (32, 64, 128, 256, 256, 128, 64, 32)),
    "Res16UNet34C": _variant(_L34, (32, 64, 128, 256, 256, 128, 96, 96)),
    "Res16UNet34D": _variant(_L34, (32, 64, 128, 256, 256, 128, 96, 128)),
    "Custom30M": _variant(_L34, (32, 64, 128, 256, 128, 64, 64, 32)),
}


def backbone_config(name: str) -> BackboneConfig:
    """The named variant; the flagship is Res16UNet34C (reference
    models/backbone.py:5-7)."""
    return BACKBONE_VARIANTS[name]


def banded_convs(cfg: BackboneConfig) -> int:
    """k3 convs of one forward that the routing sends to the banded kernel
    when both finest levels qualify by rows: those with cin >= 86 in the
    stages at levels 0 and 1 (block1, block7, block8)."""
    exp, d0, planes, layers = cfg.expansion, cfg.init_dim, cfg.planes, cfg.layers
    # (first block's k3 input, later blocks' k3 input) per stage
    stages = [(d0, planes[0] * exp, planes[0], layers[0]),
              (planes[6] + planes[0] * exp, planes[6] * exp, planes[6],
               layers[6]),
              (planes[7] + d0, planes[7] * exp, planes[7], layers[7])]
    count = 0
    for first_in, later_in, p, n in stages:
        for b in range(n):
            ins = ((p,) if cfg.block == "bottleneck"
                   else (first_in if b == 0 else later_in, p))
            count += sum(c >= BANDED_MIN_CIN for c in ins)
    return count


class Res16UNet(nn.Module):
    """Res16UNet of ``cfg.block``s; forward(pyr, feats) -> 5 FPN maps
    [stride 16, 8, 4, 2, 1], each [N_l_pad, C] with zero pad rows."""

    def __init__(self, cfg: BackboneConfig = BackboneConfig()):
        super().__init__()
        if cfg.block not in _BLOCKS:
            raise ValueError(f"block {cfg.block!r}: 'basic' or 'bottleneck'")
        self.cfg = cfg
        planes, layers, d0 = cfg.planes, cfg.layers, cfg.init_dim
        exp = cfg.expansion
        mom = cfg.bn_momentum
        self.conv0p1s1 = SparseConv(cfg.conv1_kernel_size ** 3,
                                    cfg.in_channels, d0)
        self.bn0 = BatchNorm(d0, mom)
        down_in = d0
        for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2")):
            setattr(self, name, SparseConv(8, down_in, down_in))
            setattr(self, f"bn{i + 1}", BatchNorm(down_in, mom))
            setattr(self, f"block{i + 1}",
                    self._stage(down_in, planes[i], layers[i], mom))
            down_in = planes[i] * exp
        # the skips carry the block expansion, as the reference's inplanes
        # updates (reference res16unet.py:140,163,186,209)
        skips = [planes[2] * exp, planes[1] * exp, planes[0] * exp, d0]
        tr_in = planes[3] * exp
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            i = 4 + j
            setattr(self, name, SparseConv(8, tr_in, planes[i]))
            setattr(self, f"bntr{i}", BatchNorm(planes[i], mom))
            setattr(self, f"block{i + 1}",
                    self._stage(planes[i] + skips[j], planes[i], layers[i],
                                mom))
            tr_in = planes[i] * exp

    def _stage(self, cin, planes, n_blocks, momentum):
        block = _BLOCKS[self.cfg.block]
        out = planes * self.cfg.expansion
        return nn.ModuleList(block(cin if b == 0 else out, planes, momentum)
                             for b in range(n_blocks))

    def _use_banded(self, x: torch.Tensor) -> bool:
        flag = self.cfg.banded_conv
        return x.is_cuda if flag is None else bool(flag)

    def _stem(self, feats, lv0, training: bool):
        w = self.conv0p1s1.kernel
        if (self._use_banded(feats) and not training
                and self.cfg.conv1_kernel_size == 5
                and lv0.k5.shape[0] >= BANDED_MIN_ROWS):
            return banded_stem_conv(feats, lv0.k5, w)
        return sparse_conv(feats, lv0.k5, w)

    def forward(self, pyr: PaddedPyramid, feats: torch.Tensor,
                bn_stats: dict | None = None):
        """``bn_stats``: None for eval; a dict for training (batch
        statistics; the new running statistics land in it)."""
        lv = pyr.levels
        use_banded = self._use_banded(feats)

        def run_stage(stage, x, level_idx):
            level = lv[level_idx]
            banded = (use_banded and level_idx < BANDED_LEVELS
                      and level.k3.shape[0] >= BANDED_MIN_ROWS)
            for blk in stage:
                x = blk(x, level.k3, level.valid, banded, bn_stats)
            return x

        out = torch.relu(self.bn0(self._stem(feats, lv[0], bn_stats is not None),
                                  lv[0].valid, bn_stats))
        skips = [out]
        for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2")):
            out = sparse_conv(out, lv[i].down, getattr(self, name).kernel)
            out = torch.relu(getattr(self, f"bn{i + 1}")(out, lv[i + 1].valid,
                                                         bn_stats))
            out = run_stage(getattr(self, f"block{i + 1}"), out, i + 1)
            skips.append(out)

        feature_maps = [out]
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            i, tgt = 4 + j, 3 - j
            out = sparse_conv_transpose(out, lv[tgt].up_parent,
                                        lv[tgt].up_offset,
                                        getattr(self, name).kernel)
            out = torch.relu(getattr(self, f"bntr{i}")(out, lv[tgt].valid,
                                                       bn_stats))
            out = torch.cat([out, skips[tgt]], dim=1)
            out = run_stage(getattr(self, f"block{i + 1}"), out, tgt)
            feature_maps.append(out)
        return feature_maps


@torch.no_grad()
def init_res16unet(cfg: BackboneConfig = BackboneConfig(), seed: int = 0,
                   device="cuda") -> Res16UNet:
    """The backbone alone with random weights drawn from
    ``torch.Generator(seed)`` (ME's uniform +-1/sqrt(cin * K) for the
    convs, identity BatchNorm), in eval mode on ``device``."""
    g = torch.Generator().manual_seed(seed)
    net = Res16UNet(cfg)
    for mod in net.modules():
        if isinstance(mod, SparseConv):
            k = mod.kernel
            vol, cin = (k.shape[0], k.shape[1]) if k.dim() == 3 else (1, k.shape[0])
            k.copy_((torch.rand(k.shape, generator=g) * 2 - 1)
                    * (cin * vol) ** -0.5)
    return net.to(device).eval()
