"""Res16UNet34C sparse-voxel UNet, eval mode (counterpart of
the JAX package's ``models/backbone.py`` for the BasicBlock variants).

  stem conv k=5 at stride 1 -> 4 down stages (k=2 s=2 conv + BasicBlocks)
  -> 4 up stages (k=2 s=2 transposed conv + skip concat + BasicBlocks),
  emitting 5 feature maps at strides 16/8/4/2/1.

Module and parameter names are the reference's (conv0p1s1, bn0, block1,
..., convtr7p2s2, block8; ``.kernel`` for sparse-conv weights, ``.bn`` under
each BatchNorm), so reference state dicts map onto this module key for key
(utils/ckpt.py). Conv kernels are held in ``kernel_offsets`` order.

Routing of the CUDA kernels mirrors the JAX package on the TPU:
  * k3 convs at pyramid levels 0 and 1 with >= 32768 padded rows and
    cin >= 86 (where the TPU's packed strips lose: 3 * cin * 2 B > 512 B)
    go to ``ops.banded_conv`` -- block7 and block8 of Res16UNet34C;
  * the k5 stem at level 0 with >= 32768 padded rows goes to
    ``ops.banded_stem``;
  * every other conv is the plain float32 gather-GEMM.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from agile3d_torch.config import BackboneConfig
from agile3d_torch.ops.banded_conv import banded_conv
from agile3d_torch.ops.banded_stem import banded_stem_conv
from agile3d_torch.ops.norm import batch_norm
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
    """Masked eval BatchNorm; statistics live under ``.bn`` as in the
    reference's MinkowskiBatchNorm."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = _BNStats(c)

    def forward(self, x, valid):
        s = self.bn
        return batch_norm(x, valid, s.weight, s.bias, s.running_mean,
                          s.running_var)


class BasicBlock(nn.Module):
    """conv k3 -> BN -> relu -> conv k3 -> BN (+ 1x1 downsample when
    cin != planes) -> add residual -> relu."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = SparseConv(27, cin, planes)
        self.norm1 = BatchNorm(planes)
        self.conv2 = SparseConv(27, planes, planes)
        self.norm2 = BatchNorm(planes)
        self.downsample = (nn.Sequential(SparseConv(1, cin, planes),
                                         BatchNorm(planes))
                           if cin != planes else None)

    def forward(self, x, k3, valid, banded: bool):
        conv3 = _conv3_banded if banded else sparse_conv
        out = torch.relu(self.norm1(conv3(x, k3, self.conv1.kernel), valid))
        out = self.norm2(conv3(out, k3, self.conv2.kernel), valid)
        if self.downsample is not None:
            residual = self.downsample[1](
                linear(x, self.downsample[0].kernel), valid)
        else:
            residual = x
        return torch.relu(out + residual)


def _conv3_banded(x, k3, w):
    if x.shape[1] >= BANDED_MIN_CIN:
        return banded_conv(x, k3, w)
    return sparse_conv(x, k3, w)


class Res16UNet(nn.Module):
    """Res16UNet with BasicBlocks; forward(pyr, feats) -> 5 FPN maps
    [stride 16, 8, 4, 2, 1], each [N_l_pad, C] with zero pad rows."""

    def __init__(self, cfg: BackboneConfig = BackboneConfig()):
        super().__init__()
        self.cfg = cfg
        planes, layers, d0 = cfg.planes, cfg.layers, cfg.init_dim
        self.conv0p1s1 = SparseConv(cfg.conv1_kernel_size ** 3,
                                    cfg.in_channels, d0)
        self.bn0 = BatchNorm(d0)
        down_in = d0
        for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2")):
            setattr(self, name, SparseConv(8, down_in, down_in))
            setattr(self, f"bn{i + 1}", BatchNorm(down_in))
            setattr(self, f"block{i + 1}",
                    self._stage(down_in, planes[i], layers[i]))
            down_in = planes[i]
        skips = [planes[2], planes[1], planes[0], d0]
        tr_in = planes[3]
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            i = 4 + j
            setattr(self, name, SparseConv(8, tr_in, planes[i]))
            setattr(self, f"bntr{i}", BatchNorm(planes[i]))
            setattr(self, f"block{i + 1}",
                    self._stage(planes[i] + skips[j], planes[i], layers[i]))
            tr_in = planes[i]

    @staticmethod
    def _stage(cin, planes, n_blocks):
        return nn.ModuleList(BasicBlock(cin if b == 0 else planes, planes)
                             for b in range(n_blocks))

    def _use_banded(self, x: torch.Tensor) -> bool:
        flag = self.cfg.banded_conv
        return x.is_cuda if flag is None else bool(flag)

    def _stem(self, feats, lv0):
        w = self.conv0p1s1.kernel
        if (self._use_banded(feats) and self.cfg.conv1_kernel_size == 5
                and lv0.k5.shape[0] >= BANDED_MIN_ROWS):
            return banded_stem_conv(feats, lv0.k5, w)
        return sparse_conv(feats, lv0.k5, w)

    def forward(self, pyr: PaddedPyramid, feats: torch.Tensor):
        lv = pyr.levels
        use_banded = self._use_banded(feats)

        def run_stage(stage, x, level_idx):
            level = lv[level_idx]
            banded = (use_banded and level_idx < BANDED_LEVELS
                      and level.k3.shape[0] >= BANDED_MIN_ROWS)
            for blk in stage:
                x = blk(x, level.k3, level.valid, banded)
            return x

        out = torch.relu(self.bn0(self._stem(feats, lv[0]), lv[0].valid))
        skips = [out]
        for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2")):
            out = sparse_conv(out, lv[i].down, getattr(self, name).kernel)
            out = torch.relu(getattr(self, f"bn{i + 1}")(out, lv[i + 1].valid))
            out = run_stage(getattr(self, f"block{i + 1}"), out, i + 1)
            skips.append(out)

        feature_maps = [out]
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            i, tgt = 4 + j, 3 - j
            out = sparse_conv_transpose(out, lv[tgt].up_parent,
                                        lv[tgt].up_offset,
                                        getattr(self, name).kernel)
            out = torch.relu(getattr(self, f"bntr{i}")(out, lv[tgt].valid))
            out = torch.cat([out, skips[tgt]], dim=1)
            out = run_stage(getattr(self, f"block{i + 1}"), out, tgt)
            feature_maps.append(out)
        return feature_maps
