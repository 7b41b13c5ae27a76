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
  * every other conv is the plain gather-GEMM (``ops/sparse_conv.py``);
    with gradients its backward gathers through the inverse map
    (``GatherConv``) where the rows are the whole pyramid's
    (``rows.inverse_maps``): the stencils are named as such, the down convs
    are handed their level's ``up_parent`` / ``up_offset``, the transposed
    convs the finer level's ``down``.

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

``compute_dtype=torch.bfloat16`` is the JAX package's bf16 backbone
(``backbone_forward(..., compute_dtype=jnp.bfloat16)``), promotion for
promotion, as a ``jax.make_jaxpr`` trace of it shows: the features and
every float32 weight (conv kernels, BatchNorm scale and bias; not the
running statistics) are cast to bf16; the stem's, the down convs' and the
up convs' BatchNorm runs on the input cast to f32 and casts its output
back to bf16; the residual blocks' BatchNorm takes its input as it comes.
So in eval a block's normalisation against the f32 running statistics
promotes to f32, the rest of that block and the next convs run in f32
against bf16 weights, and the five FPN maps come out f32; in training the
batch statistics are bf16 and so are the maps. The kernels take the
operands in either dtype and return the input's (``ops/banded_conv.py``).
Eval reads a bf16 copy of the weights made once per model (again only when
a weight changes); training casts inside autograd, so the gradients reach
the f32 weights.
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


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


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

    def forward(self, x, valid, bn_stats=None, cast=_same, reduce=None):
        """``cast`` gives the weight and bias in the compute dtype;
        ``reduce`` sums the batch's moments over the ranks that hold its
        other rows (``ops/norm.py::batch_norm_train``)."""
        s = self.bn
        weight, bias = cast(s.weight), cast(s.bias)
        if bn_stats is None:
            return batch_norm(x, valid, weight, bias, s.running_mean,
                              s.running_var)
        y, mean, var = batch_norm_train(x, valid, weight, bias,
                                        s.running_mean, s.running_var,
                                        self.momentum, reduce)
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

    def forward(self, x, conv3, norm, cast=_same):
        """``conv3(x, w)``: the stage's k3 conv; ``norm(module, x)``: its
        BatchNorm (``Res16UNet.forward``'s ``run_stage``)."""
        out = torch.relu(norm(self.norm1, conv3(x, cast(self.conv1.kernel))))
        out = norm(self.norm2, conv3(out, cast(self.conv2.kernel)))
        return torch.relu(out + _residual(self, x, norm, cast))


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

    def forward(self, x, conv3, norm, cast=_same):
        """As ``BasicBlock.forward``."""
        out = torch.relu(norm(self.norm1, linear(x, cast(self.conv1.kernel))))
        out = torch.relu(norm(self.norm2, conv3(out,
                                                cast(self.conv2.kernel))))
        out = norm(self.norm3, linear(out, cast(self.conv3.kernel)))
        return torch.relu(out + _residual(self, x, norm, cast))


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def _residual(block, x, norm, cast):
    """The block's input, through its 1x1 downsample and BatchNorm when it
    has one."""
    if block.downsample is None:
        return x
    conv, bn = block.downsample
    return norm(bn, linear(x, cast(conv.kernel)))


def _conv3_banded(x, k3, w):
    # banded routing runs on the whole pyramid's rows only
    if x.shape[1] >= BANDED_MIN_CIN:
        return BandedConv.apply(x, k3, w)
    return sparse_conv(x, k3, w, stencil=True)


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

    def _stem(self, feats, lv0, training: bool, w, banded: bool,
              stencil: bool):
        if (banded and not training
                and self.cfg.conv1_kernel_size == 5
                and lv0.k5.shape[0] >= BANDED_MIN_ROWS):
            return banded_stem_conv(feats, lv0.k5, w)
        return sparse_conv(feats, lv0.k5, w, stencil=stencil)

    def _caster(self, dtype, training: bool):
        """The function that gives each float32 weight in ``dtype``: the
        weight itself when ``dtype`` is None; in training a cast inside
        autograd; in eval the weight's entry in a copy made once per model
        and made again only when a weight changed (its storage or its
        in-place version), kept out of the state dict."""
        if dtype is None:
            return _same
        if training:
            return lambda t: t.to(dtype) if t.dtype == torch.float32 else t
        params = list(self.parameters())
        key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
        cached = self.__dict__.get("_cast_weights")
        if cached is None or cached[0] != key:
            # ordinary tensors even when called under inference_mode
            with torch.inference_mode(False), torch.no_grad():
                copies = {p: p.detach().to(dtype) if p.dtype == torch.float32
                          else p for p in params}
            self.__dict__["_cast_weights"] = cached = (key, copies)
        return cached[1].__getitem__

    def forward(self, pyr: PaddedPyramid, feats: torch.Tensor,
                bn_stats: dict | None = None, compute_dtype=None,
                rows=None):
        """``bn_stats``: None for eval; a dict for training (batch
        statistics; the new running statistics land in it).
        ``compute_dtype``: None (float32) or ``torch.bfloat16``, the JAX
        package's bf16 policy (module docstring). ``rows``: None when
        ``pyr`` holds every row; a rank's block of a row-sharded pyramid
        gives its hooks (``parallel/sp_backbone.py::RowShards``: ``banded``
        and ``inverse_maps`` False, ``exchange(x, level)`` appends the halo
        rows a conv on that level's maps reads, ``reduce`` sums BatchNorm's
        moments)."""
        lv = pyr.levels
        rows = rows or _ALL_ROWS
        use_banded = rows.banded and self._use_banded(feats)
        inv = rows.inverse_maps
        training = bn_stats is not None
        cast = self._caster(compute_dtype, training)
        if compute_dtype is not None:
            feats = feats.to(compute_dtype)

        def bn(norm, x, valid):
            # the stem's and the up and down convs' BatchNorm: in f32, the
            # output back in the compute dtype
            if compute_dtype is None:
                return norm(x, valid, bn_stats, cast, rows.reduce)
            return norm(x.float(), valid, bn_stats, cast,
                        rows.reduce).to(compute_dtype)

        def run_stage(stage, x, level_idx):
            level = lv[level_idx]
            banded = (use_banded and level_idx < BANDED_LEVELS
                      and level.k3.shape[0] >= BANDED_MIN_ROWS)

            def conv3(x, w):
                x = rows.exchange(x, level)
                if banded:
                    return _conv3_banded(x, level.k3, w)
                return sparse_conv(x, level.k3, w, stencil=inv)

            def norm(module, x):
                return module(x, level.valid, bn_stats, cast, rows.reduce)

            for blk in stage:
                x = blk(x, conv3, norm, cast)
            return x

        stem = self._stem(rows.exchange(feats, lv[0]), lv[0], training,
                          cast(self.conv0p1s1.kernel), use_banded, inv)
        out = torch.relu(bn(self.bn0, stem, lv[0].valid))
        skips = [out]
        for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                                  "conv4p8s2")):
            out = sparse_conv(rows.exchange(out, lv[i]), lv[i].down,
                              cast(getattr(self, name).kernel),
                              up=(lv[i].up_parent, lv[i].up_offset)
                              if inv else None)
            out = torch.relu(bn(getattr(self, f"bn{i + 1}"), out,
                                lv[i + 1].valid))
            out = run_stage(getattr(self, f"block{i + 1}"), out, i + 1)
            skips.append(out)

        feature_maps = [out]
        for j, name in enumerate(("convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2")):
            i, tgt = 4 + j, 3 - j
            out = sparse_conv_transpose(rows.exchange(out, lv[tgt + 1]),
                                        lv[tgt].up_parent,
                                        lv[tgt].up_offset,
                                        cast(getattr(self, name).kernel),
                                        down=lv[tgt].down if inv else None)
            out = torch.relu(bn(getattr(self, f"bntr{i}"), out,
                                lv[tgt].valid))
            out = torch.cat([out, skips[tgt]], dim=1)
            out = run_stage(getattr(self, f"block{i + 1}"), out, tgt)
            feature_maps.append(out)
        return feature_maps


class _AllRows:
    """``Res16UNet.forward``'s hooks when the pyramid holds every row: the
    level's maps index these rows, so their inverses hold
    (``inverse_maps``)."""

    banded = True
    inverse_maps = True
    reduce = None

    @staticmethod
    def exchange(x, level):
        return x


_ALL_ROWS = _AllRows()


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
