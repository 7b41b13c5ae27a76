"""AGILE3D: the click-as-query decoder over a sparse UNet (counterpart of
the JAX package's ``models/agile3d.py``).

  forward_backbone  -- the UNet, ``lin_squeeze``, the per-sample gather and
                       the positional encoding, once per scene
  forward_mask      -- the decoder, once per click round; with gradients
                       on, each refinement round is rematerialised in the
                       backward (torch.utils.checkpoint), as the JAX
                       package's jax.checkpoint(round_body) does

The decoder runs the JAX package's two policies. Attention: dense while
the [B, H, Q, N] logits volume is small, else chunked over the voxel axis
(``_pick_attn_chunk``), with each key chunk's bias rebuilt from the
compact (labels, present) round state so that the [B, Q, N] bias is never
built. Dtype: ``decoder_dtype="bfloat16"`` runs on a bf16 copy of the
decoder's weights, made once per model (and again only when the weights
change), with the scene's ``mask_feat`` and ``pos_pcd`` in bf16 and
``raw``, ``cmin`` and ``cmax`` in f32; every mixed op promotes as in JAX,
the attention statistics are f32, each round's queries and voxel features
go back to bf16 at its end, and the mask logits are f32.

Clicks are a padded [B, MAX_CLICKS] (voxel, object, time) table and objects
are padded to 1 + max_fg_objects mask columns. Query slots [0, nbg) are the
learned background queries and the click queries follow in insertion order.

Module names are the reference's (``lin_squeeze_head``, ``bg_query_feat``,
``mask_embed_head``, ``decoder_norm``, ``pos_enc.gauss_B``,
``c2s_attention[d][i]``, ...), so its state dict maps onto this module key
for key (utils/ckpt.py).
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from agile3d_torch.config import ModelConfig
from agile3d_torch.models.backbone import Res16UNet, SparseConv
from agile3d_torch.ops.attention import (
    NEG_INF,
    CrossAttentionLayer,
    FFNLayer,
    SelfAttentionLayer,
    matmul,
)
from agile3d_torch.ops.norm import layer_norm
from agile3d_torch.ops.pos_enc import fourier_pos, positional_encoding_1d, sine_pos
from agile3d_torch.ops.sparse_conv import linear
from agile3d_torch.sparse.grid import PaddedPyramid


class ClickState(NamedTuple):
    vox: torch.Tensor   # int [B, MC] voxel slot in the sample, -1 unused
    obj: torch.Tensor   # int [B, MC] object id, 0 = background
    time: torch.Tensor  # int [B, MC] global click-order index


class SceneFeatures(NamedTuple):
    """Output of forward_backbone, read by every click round."""

    mask_feat: torch.Tensor  # [B, Ns, C] squeezed stride-1 features
    pos_pcd: torch.Tensor    # [B, Ns, C] positional encoding of raw coords
    vox_valid: torch.Tensor  # bool [B, Ns]
    raw: torch.Tensor        # [B, Ns, 3] raw coords
    cmin: torch.Tensor       # [B, 3]
    cmax: torch.Tensor       # [B, 3]


class _PosEnc(nn.Module):
    def __init__(self, d_half: int):
        super().__init__()
        self.register_buffer("gauss_B", torch.empty(3, d_half))


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


# ModelConfig.backbone_dtype -> Res16UNet.forward's compute_dtype
_BACKBONE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# the modules and buffers that forward_mask reads
_DECODER_PARTS = ("bg_query_feat", "bg_query_pos", "mask_embed_head",
                  "decoder_norm", "pos_enc", "c2s_attention", "c2c_attention",
                  "ffn_attention", "s2c_attention")


def _pick_attn_chunk(n: int, logits_volume: int, cfg: ModelConfig) -> int:
    """Chunk of the voxel axis for the chunked attention, 0 = dense: the
    largest power-of-two divisor of ``n`` from ``cfg.attn_chunk`` down to
    4096 that gives at least 6 chunks, once the logits volume exceeds
    ``cfg.attn_dense_threshold`` (the JAX package's rule and thresholds)."""
    if not cfg.attn_chunk or logits_volume <= cfg.attn_dense_threshold:
        return 0
    c = cfg.attn_chunk
    while c >= 4096:
        if n % c == 0 and n // c >= 6:
            return c
        c //= 2
    return 0


def _round_bias_chunk(labels, present, safe_obj, vox_valid):
    """bias_fn(start, size) for the key-chunked attention: the [B, Q, size]
    slice of ``Agile3D._round_bias_dense``, rebuilt from the compact
    (labels, present) state."""
    sel_present = torch.gather(present, 1, safe_obj)[:, :, None]   # [B, Q, 1]
    zero = torch.zeros((), device=labels.device)
    neg = torch.full((), NEG_INF, device=labels.device)

    def bias_fn(start: int, size: int):
        lab = labels[:, start:start + size]
        mismatch = lab[:, None, :] != safe_obj[:, :, None]           # [B, Q, s]
        bias = torch.where(sel_present & mismatch, neg, zero)
        pad = torch.where(vox_valid[:, start:start + size], zero, neg)
        return bias + pad[:, None, :]

    return bias_fn


class Agile3D(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        if any(h != 4 for h in cfg.hlevels):
            raise NotImplementedError(
                "hlevels entries must all be 4: the reference's coarse-hlevel "
                "path is structurally broken, so only repeated-finest "
                "configurations are supported")
        if cfg.backbone_dtype not in _BACKBONE_DTYPES:
            raise ValueError(f"backbone_dtype {cfg.backbone_dtype!r}")
        if cfg.backbone.block != "basic":
            raise ValueError(
                f"block {cfg.backbone.block!r}: the model takes BasicBlock "
                f"backbones only. A Bottleneck backbone's stride-1 output has "
                f"planes[7] * 4 = {cfg.backbone.planes[7] * 4} channels, and "
                f"the JAX package's lin_squeeze takes planes[7] = "
                f"{cfg.backbone.planes[7]} (agile3d_tpu/models/agile3d.py:117), "
                f"so its forward_backbone fails the same way; run the "
                f"backbone alone (models/backbone.py::Res16UNet)")
        self.cfg = cfg
        c = cfg.hidden_dim
        self.backbone = Res16UNet(cfg.backbone)
        self.lin_squeeze_head = SparseConv(1, cfg.backbone.planes[7], c)
        self.lin_squeeze_head.bias = nn.Parameter(torch.zeros(c))
        self.bg_query_feat = nn.Embedding(cfg.num_bg_queries, c)
        self.bg_query_pos = nn.Embedding(cfg.num_bg_queries, c)
        self.mask_embed_head = nn.Sequential(nn.Linear(c, c), nn.ReLU(),
                                             nn.Linear(c, c))
        self.decoder_norm = nn.LayerNorm(c)
        self.pos_enc = _PosEnc(c // 2)
        n_sets = 1 if cfg.shared_decoder else cfg.num_decoders
        n_slots = len(cfg.hlevels)

        def layers(make):
            return nn.ModuleList(nn.ModuleList(make() for _ in range(n_slots))
                                 for _ in range(n_sets))

        h, pre, drop = cfg.num_heads, cfg.pre_norm, cfg.dropout
        self.c2s_attention = layers(
            lambda: CrossAttentionLayer(c, h, pre, drop))
        self.c2c_attention = layers(lambda: SelfAttentionLayer(c, h, pre, drop))
        self.ffn_attention = layers(
            lambda: FFNLayer(c, cfg.dim_feedforward, pre, drop))
        self.s2c_attention = layers(
            lambda: CrossAttentionLayer(c, h, pre, drop))
        self.register_buffer("time_pe", torch.from_numpy(
            positional_encoding_1d(c, cfg.time_table_len)), persistent=False)

    # ------------------------------------------------------------------
    # Phase 1: backbone, once per scene
    # ------------------------------------------------------------------

    def _pos(self, xyz, cmin, cmax, gauss_b):
        cfg = self.cfg
        if cfg.positional_encoding_type == "fourier":
            return fourier_pos(xyz, gauss_b, cmin, cmax,
                               normalize=cfg.normalize_pos_enc)
        if cfg.positional_encoding_type == "sine":
            return sine_pos(xyz, cfg.hidden_dim, cmin, cmax,
                            normalize=cfg.normalize_pos_enc)
        raise ValueError(cfg.positional_encoding_type)

    def forward_backbone(self, pyr: PaddedPyramid, feats: torch.Tensor,
                         raw_coords: torch.Tensor, sample_idx: torch.Tensor,
                         bn_stats: dict | None = None) -> SceneFeatures:
        """pyr on the device; feats/raw_coords [N0, 3] flat; sample_idx
        [B, Ns] flat rows per sample slot, -1 pad. ``bn_stats`` (a dict)
        runs the backbone in training mode (see ``Res16UNet.forward``);
        ``cfg.backbone_dtype`` selects its dtype policy."""
        fmaps = self.backbone(pyr, feats, bn_stats,
                              compute_dtype=_BACKBONE_DTYPES[
                                  self.cfg.backbone_dtype])
        squeezed = linear(fmaps[-1].float(), self.lin_squeeze_head.kernel,
                          self.lin_squeeze_head.bias,
                          valid=pyr.levels[0].valid)
        vox_valid = sample_idx >= 0
        safe = sample_idx.clamp(0, squeezed.shape[0] - 1).long()
        mask_feat = _where0(vox_valid[..., None], squeezed[safe])
        raw_b = _where0(vox_valid[..., None], raw_coords[safe])
        big = torch.tensor(3.4e38, dtype=raw_b.dtype, device=raw_b.device)
        cmin = torch.where(vox_valid[..., None], raw_b, big).amin(dim=1)
        cmax = torch.where(vox_valid[..., None], raw_b, -big).amax(dim=1)
        pos_pcd = self._pos(raw_b, cmin[:, None, :], cmax[:, None, :],
                            self.pos_enc.gauss_B)
        pos_pcd = _where0(vox_valid[..., None], pos_pcd)
        if self.cfg.decoder_dtype == "bfloat16":
            # once per scene: every click round reads these two
            mask_feat = mask_feat.to(torch.bfloat16)
            pos_pcd = pos_pcd.to(torch.bfloat16)
        return SceneFeatures(mask_feat=mask_feat, pos_pcd=pos_pcd,
                             vox_valid=vox_valid, raw=raw_b, cmin=cmin,
                             cmax=cmax)

    # ------------------------------------------------------------------
    # Phase 2: decoder, once per click round
    # ------------------------------------------------------------------

    @staticmethod
    def _mask_module(w, queries, src, query_obj, query_valid, col_valid,
                     vox_valid):
        """Mask head with the decoder weights ``w``: LayerNorm -> MLP ->
        voxel-query dot products -> per-object max over that object's click
        queries. Returns (out [B, N, 1+K] with invalid columns at NEG_INF,
        labels [B, N] argmax (-1 on pad rows), present [B, 1+K]): (labels,
        present) is the compact state from which the next round's attention
        bias is rebuilt. The logits are f32 (their operands are f32 under
        both dtype policies, as in JAX)."""
        l1, l2 = w.mask_embed_head[0], w.mask_embed_head[2]
        qn = layer_norm(queries, w.decoder_norm.weight, w.decoder_norm.bias)
        emb = torch.relu(matmul(qn, l1.weight.T) + l1.bias)
        emb = matmul(emb, l2.weight.T) + l2.bias                   # [B, Q, C]
        logits = torch.einsum("bnc,bqc->bnq", src, emb)            # [B, N, Q]
        neg = torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device)
        cols = []
        for o in range(col_valid.shape[1]):
            sel = (query_obj == o) & query_valid                   # [B, Q]
            cols.append(torch.where(sel[:, None, :], logits, neg).amax(dim=-1))
        out = torch.stack(cols, dim=-1)                            # [B, N, 1+K]
        out = torch.where(col_valid[:, None, :], out, neg)
        labels = out.argmax(dim=-1)
        labels = torch.where(vox_valid, labels, torch.full_like(labels, -1))
        obj_ids = torch.arange(col_valid.shape[1], device=labels.device)
        present = (labels[:, None, :] == obj_ids[None, :, None]).any(dim=-1)
        return out, labels, present

    @staticmethod
    def _round_bias_dense(labels, present, safe_obj, vox_valid):
        """[B, Q, N] bias of one round, rebuilt from (labels, present): click
        queries of a present object see only the voxels labelled with it;
        pad voxels are masked for every query."""
        sel_present = torch.gather(present, 1, safe_obj)            # [B, Q]
        mismatch = labels[:, None, :] != safe_obj[:, :, None]       # [B, Q, N]
        zero = torch.zeros((), device=labels.device)
        neg = torch.full((), NEG_INF, device=labels.device)
        bias = torch.where(sel_present[:, :, None] & mismatch, neg, zero)
        return bias + torch.where(vox_valid, zero, neg)[:, None, :]

    def _decoder_weights(self):
        """The module whose decoder weights ``forward_mask`` reads: the
        model itself in f32; under ``decoder_dtype="bfloat16"`` a bf16 copy
        of its decoder parts, made again only when a weight changed (its
        storage or its in-place version), kept out of the state dict."""
        if self.cfg.decoder_dtype == "float32":
            return self
        if self.cfg.decoder_dtype != "bfloat16":
            raise ValueError(f"decoder_dtype {self.cfg.decoder_dtype!r}")
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the bf16 decoder runs without gradients only (its weights "
                "are a copy); train with decoder_dtype='float32'")
        src = [t for name in _DECODER_PARTS
               for part in (getattr(self, name),)
               for t in (*part.parameters(), *part.buffers())]
        src.append(self.time_pe)
        key = tuple((t.data_ptr(), t._version) for t in src)
        cached = self.__dict__.get("_bf16_decoder")
        if cached is None or cached[0] != key:
            # ordinary tensors even when called under inference_mode
            with torch.inference_mode(False), torch.no_grad():
                twin = nn.Module()
                for name in _DECODER_PARTS:
                    setattr(twin, name, copy.deepcopy(getattr(self, name)))
                twin.register_buffer("time_pe", self.time_pe.clone())
                twin.to(torch.bfloat16)
            self.__dict__["_bf16_decoder"] = (key, twin)
        return self.__dict__["_bf16_decoder"][1]

    def forward_mask(self, scene: SceneFeatures, clicks: ClickState,
                     num_obj: torch.Tensor,
                     train_gen: torch.Generator | None = None) -> dict:
        """All refinement rounds for the current click table. Returns
        pred_masks [B, N, 1 + max_fg_objects] (last round) and aux_masks
        [R-1, B, N, 1 + max_fg_objects] (earlier rounds), in f32.

        ``train_gen`` turns on ``cfg.dropout`` (training; None in eval and
        in the click rollouts). It seeds four streams per round, drawn in
        the JAX package's order (c2s, c2c, ffn, s2c), each a generator of
        its own on the decoder's device, so that a round recomputed in the
        backward draws its masks again. Dropout > 0 runs dense attention,
        as the JAX package does: its chunked forms carry no probability
        dropout."""
        cfg = self.cfg
        w = self._decoder_weights()
        if w is not self:
            scene = scene._replace(mask_feat=scene.mask_feat.to(torch.bfloat16),
                                   pos_pcd=scene.pos_pcd.to(torch.bfloat16))
        b, n, c = scene.mask_feat.shape
        nbq = cfg.num_bg_queries
        dev = scene.mask_feat.device

        click_valid = clicks.vox >= 0                               # [B, MC]
        safe_vox = clicks.vox.clamp(0, n - 1).long()
        cfeat = torch.gather(scene.mask_feat, 1,
                             safe_vox[..., None].expand(-1, -1, c))
        cfeat = _where0(click_valid[..., None], cfeat)
        cxyz = torch.gather(scene.raw, 1, safe_vox[..., None].expand(-1, -1, 3))
        cpos = self._pos(cxyz, scene.cmin[:, None, :], scene.cmax[:, None, :],
                         w.pos_enc.gauss_B)
        t_safe = clicks.time.clamp(0, w.time_pe.shape[0] - 1).long()
        cpos = cpos + w.time_pe[t_safe]
        cpos = _where0(click_valid[..., None], cpos)

        queries = torch.cat([w.bg_query_feat.weight[None].expand(b, -1, -1),
                             cfeat], dim=1)                         # [B, Q, C]
        query_pos = torch.cat([w.bg_query_pos.weight[None].expand(b, -1, -1),
                               cpos], dim=1)
        query_obj = torch.cat([torch.zeros((b, nbq), dtype=torch.long, device=dev),
                               clicks.obj.long()], dim=1)
        query_valid = torch.cat([torch.ones((b, nbq), dtype=torch.bool, device=dev),
                                 click_valid], dim=1)
        zero = torch.zeros((), device=dev)
        q_key_bias = torch.where(query_valid, zero,
                                 torch.full((), NEG_INF, device=dev))[:, None, :]

        n_cols = 1 + cfg.max_fg_objects
        col_valid = (torch.arange(n_cols, device=dev)[None, :]
                     <= num_obj.to(dev)[:, None])
        safe_obj = query_obj.clamp(0, n_cols - 1)
        chunk = _pick_attn_chunk(n, b * queries.shape[1] * n * cfg.num_heads,
                                 cfg)
        n_slots = len(cfg.hlevels)
        n_rounds = cfg.num_decoders * n_slots
        seeds = [[None] * 4] * n_rounds
        if train_gen is not None and cfg.dropout > 0:
            chunk = 0
            seeds = torch.randint(2 ** 62, (n_rounds, 4), generator=train_gen,
                                  device=train_gen.device).tolist()
        cdt = scene.mask_feat.dtype

        src = scene.mask_feat
        # no object present yet -> fully open rows (the reference's zero
        # initial attention mask)
        labels = torch.zeros((b, n), dtype=torch.long, device=dev)
        present = torch.zeros((b, n_cols), dtype=torch.bool, device=dev)

        def round_body(d, i, seeds4, queries, src, labels, present):
            c2s, c2c, ffn, s2c = (
                None if sd is None else torch.Generator(device=dev).manual_seed(sd)
                for sd in seeds4)
            if chunk:
                c2s_bias, c2s_bias_fn = None, _round_bias_chunk(
                    labels, present, safe_obj, scene.vox_valid)
            else:
                c2s_bias, c2s_bias_fn = self._round_bias_dense(
                    labels, present, safe_obj, scene.vox_valid), None
            queries = w.c2s_attention[d][i](
                queries, src, pos=scene.pos_pcd, query_pos=query_pos,
                attn_bias=c2s_bias, attn_bias_fn=c2s_bias_fn,
                chunk_keys=chunk, generator=c2s)
            queries = w.c2c_attention[d][i](
                queries, query_pos=query_pos, attn_bias=q_key_bias,
                generator=c2c)
            queries = w.ffn_attention[d][i](queries, generator=ffn)
            src = w.s2c_attention[d][i](
                src, queries, pos=query_pos, query_pos=scene.pos_pcd,
                attn_bias=q_key_bias, chunk_queries=chunk, generator=s2c)
            masks, labels, present = self._mask_module(
                w, queries, src, query_obj, query_valid, col_valid,
                scene.vox_valid)
            # the f32 positional and bias terms promote the round's outputs:
            # back to the decoder's dtype, as JAX pins its carry (a no-op
            # in f32)
            return queries.to(cdt), src.to(cdt), labels, present, masks

        # with gradients, each round's [B, H, Q, N] attention intermediates
        # are recomputed in the backward instead of kept for all rounds
        remat = torch.is_grad_enabled()
        preds = []
        for r in range(cfg.num_decoders):
            d = 0 if cfg.shared_decoder else r
            for i in range(n_slots):
                args = (d, i, seeds[r * n_slots + i], queries, src, labels,
                        present)
                queries, src, labels, present, masks = (
                    checkpoint(round_body, *args, use_reentrant=False)
                    if remat else round_body(*args))
                preds.append(masks)
        all_masks = torch.stack(preds)
        return {
            "pred_masks": all_masks[-1],
            "aux_masks": all_masks[:-1] if len(preds) > 1 else None,
            "all_masks": all_masks,
            "attn_chunk": chunk,
        }


@torch.no_grad()
def init_agile3d(cfg: ModelConfig = ModelConfig(), seed: int = 0,
                 device="cuda") -> Agile3D:
    """A model with random weights drawn from ``torch.Generator(seed)`` in the
    reference's init distributions (ME convs uniform +-1/sqrt(cin*K), torch
    Linear defaults, xavier-uniform attention and FFN matrices, N(0, 1)
    query embeddings and Fourier matrix, identity BatchNorm), in eval
    mode on ``device``."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t, lim):
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * lim)

    model = Agile3D(cfg)
    for mod in model.modules():
        if isinstance(mod, SparseConv):
            k = mod.kernel
            vol, cin = (k.shape[0], k.shape[1]) if k.dim() == 3 else (1, k.shape[0])
            uniform_(k, (cin * vol) ** -0.5)
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g))
    c = cfg.hidden_dim
    fan = cfg.backbone.planes[7]
    uniform_(model.lin_squeeze_head.bias, fan ** -0.5)
    for lin in (model.mask_embed_head[0], model.mask_embed_head[2]):
        uniform_(lin.weight, lin.in_features ** -0.5)
        uniform_(lin.bias, lin.in_features ** -0.5)
    for mod in model.modules():
        if isinstance(mod, CrossAttentionLayer | SelfAttentionLayer):
            attn = (mod.multihead_attn if isinstance(mod, CrossAttentionLayer)
                    else mod.self_attn)
            uniform_(attn.in_proj_weight, (6.0 / (2 * c)) ** 0.5)
            uniform_(attn.out_proj.weight, (6.0 / (2 * c)) ** 0.5)
            attn.in_proj_bias.zero_()
            attn.out_proj.bias.zero_()
        elif isinstance(mod, FFNLayer):
            for lin in (mod.linear1, mod.linear2):
                uniform_(lin.weight,
                         (6.0 / (lin.in_features + lin.out_features)) ** 0.5)
                uniform_(lin.bias, lin.in_features ** -0.5)
    model.pos_enc.gauss_B.copy_(
        torch.randn(model.pos_enc.gauss_B.shape, generator=g) * cfg.gauss_scale)
    return model.to(device).eval()
