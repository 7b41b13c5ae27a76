"""AGILE3D: the click-as-query decoder over a sparse UNet (counterpart of
the JAX package's ``models/agile3d.py``).

  forward_backbone  -- the UNet, ``lin_squeeze``, the per-sample gather and
                       the positional encoding, once per scene
  forward_mask      -- the decoder, once per click round; with gradients
                       on, each refinement round is rematerialised in the
                       backward (torch.utils.checkpoint), as the JAX
                       package's jax.checkpoint(round_body) does

Clicks are a padded [B, MAX_CLICKS] (voxel, object, time) table and objects
are padded to 1 + max_fg_objects mask columns. Query slots [0, nbg) are the
learned background queries and the click queries follow in insertion order.

Module names are the reference's (``lin_squeeze_head``, ``bg_query_feat``,
``mask_embed_head``, ``decoder_norm``, ``pos_enc.gauss_B``,
``c2s_attention[d][i]``, ...), so its state dict maps onto this module key
for key (utils/ckpt.py).
"""

from __future__ import annotations

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


class Agile3D(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        if any(h != 4 for h in cfg.hlevels):
            raise NotImplementedError(
                "hlevels entries must all be 4: the reference's coarse-hlevel "
                "path is structurally broken, so only repeated-finest "
                "configurations are supported")
        if cfg.dropout > 0:
            raise NotImplementedError(
                "decoder dropout is not ported yet (dropout must be 0.0)")
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

        h, pre = cfg.num_heads, cfg.pre_norm
        self.c2s_attention = layers(lambda: CrossAttentionLayer(c, h, pre))
        self.c2c_attention = layers(lambda: SelfAttentionLayer(c, h, pre))
        self.ffn_attention = layers(
            lambda: FFNLayer(c, cfg.dim_feedforward, pre))
        self.s2c_attention = layers(lambda: CrossAttentionLayer(c, h, pre))
        self.register_buffer("time_pe", torch.from_numpy(
            positional_encoding_1d(c, cfg.time_table_len)), persistent=False)

    # ------------------------------------------------------------------
    # Phase 1: backbone, once per scene
    # ------------------------------------------------------------------

    def _pos(self, xyz, cmin, cmax):
        cfg = self.cfg
        if cfg.positional_encoding_type == "fourier":
            return fourier_pos(xyz, self.pos_enc.gauss_B, cmin, cmax,
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
        runs the backbone in training mode (see ``Res16UNet.forward``)."""
        fmaps = self.backbone(pyr, feats, bn_stats)
        squeezed = linear(fmaps[-1], self.lin_squeeze_head.kernel,
                          self.lin_squeeze_head.bias,
                          valid=pyr.levels[0].valid)
        vox_valid = sample_idx >= 0
        safe = sample_idx.clamp(0, squeezed.shape[0] - 1).long()
        mask_feat = _where0(vox_valid[..., None], squeezed[safe])
        raw_b = _where0(vox_valid[..., None], raw_coords[safe])
        big = torch.tensor(3.4e38, dtype=raw_b.dtype, device=raw_b.device)
        cmin = torch.where(vox_valid[..., None], raw_b, big).amin(dim=1)
        cmax = torch.where(vox_valid[..., None], raw_b, -big).amax(dim=1)
        pos_pcd = self._pos(raw_b, cmin[:, None, :], cmax[:, None, :])
        pos_pcd = _where0(vox_valid[..., None], pos_pcd)
        return SceneFeatures(mask_feat=mask_feat, pos_pcd=pos_pcd,
                             vox_valid=vox_valid, raw=raw_b, cmin=cmin,
                             cmax=cmax)

    # ------------------------------------------------------------------
    # Phase 2: decoder, once per click round
    # ------------------------------------------------------------------

    def _mask_module(self, queries, src, query_obj, query_valid, col_valid,
                     vox_valid):
        """Mask head: LayerNorm -> MLP -> voxel-query dot products ->
        per-object max over that object's click queries. Returns (out
        [B, N, 1+K] with invalid columns at NEG_INF, labels [B, N] argmax
        (-1 on pad rows), present [B, 1+K]): (labels, present) is the compact
        state from which the next round's attention bias is rebuilt."""
        l1, l2 = self.mask_embed_head[0], self.mask_embed_head[2]
        qn = layer_norm(queries, self.decoder_norm.weight, self.decoder_norm.bias)
        emb = torch.relu(qn @ l1.weight.T + l1.bias)
        emb = emb @ l2.weight.T + l2.bias                          # [B, Q, C]
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

    def forward_mask(self, scene: SceneFeatures, clicks: ClickState,
                     num_obj: torch.Tensor) -> dict:
        """All refinement rounds for the current click table. Returns
        pred_masks [B, N, 1 + max_fg_objects] (last round) and aux_masks
        [R-1, B, N, 1 + max_fg_objects] (earlier rounds)."""
        cfg = self.cfg
        b, n, c = scene.mask_feat.shape
        nbq = cfg.num_bg_queries
        dev = scene.mask_feat.device

        click_valid = clicks.vox >= 0                               # [B, MC]
        safe_vox = clicks.vox.clamp(0, n - 1).long()
        cfeat = torch.gather(scene.mask_feat, 1,
                             safe_vox[..., None].expand(-1, -1, c))
        cfeat = _where0(click_valid[..., None], cfeat)
        cxyz = torch.gather(scene.raw, 1, safe_vox[..., None].expand(-1, -1, 3))
        cpos = self._pos(cxyz, scene.cmin[:, None, :], scene.cmax[:, None, :])
        t_safe = clicks.time.clamp(0, self.time_pe.shape[0] - 1).long()
        cpos = cpos + self.time_pe[t_safe]
        cpos = _where0(click_valid[..., None], cpos)

        queries = torch.cat([self.bg_query_feat.weight[None].expand(b, -1, -1),
                             cfeat], dim=1)                         # [B, Q, C]
        query_pos = torch.cat([self.bg_query_pos.weight[None].expand(b, -1, -1),
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

        src = scene.mask_feat
        # no object present yet -> fully open rows (the reference's zero
        # initial attention mask)
        labels = torch.zeros((b, n), dtype=torch.long, device=dev)
        present = torch.zeros((b, n_cols), dtype=torch.bool, device=dev)
        n_slots = len(cfg.hlevels)

        def round_body(d, i, queries, src, labels, present):
            c2s_bias = self._round_bias_dense(labels, present, safe_obj,
                                              scene.vox_valid)
            queries = self.c2s_attention[d][i](
                queries, src, pos=scene.pos_pcd, query_pos=query_pos,
                attn_bias=c2s_bias)
            queries = self.c2c_attention[d][i](
                queries, query_pos=query_pos, attn_bias=q_key_bias)
            queries = self.ffn_attention[d][i](queries)
            src = self.s2c_attention[d][i](
                src, queries, pos=query_pos, query_pos=scene.pos_pcd,
                attn_bias=q_key_bias)
            masks, labels, present = self._mask_module(
                queries, src, query_obj, query_valid, col_valid,
                scene.vox_valid)
            return queries, src, labels, present, masks

        # with gradients, each round's [B, H, Q, N] attention intermediates
        # are recomputed in the backward instead of kept for all rounds
        remat = torch.is_grad_enabled()
        preds = []
        for r in range(cfg.num_decoders):
            d = 0 if cfg.shared_decoder else r
            for i in range(n_slots):
                args = (d, i, queries, src, labels, present)
                queries, src, labels, present, masks = (
                    checkpoint(round_body, *args, use_reentrant=False)
                    if remat else round_body(*args))
                preds.append(masks)
        all_masks = torch.stack(preds)
        return {
            "pred_masks": all_masks[-1],
            "aux_masks": all_masks[:-1] if len(preds) > 1 else None,
            "all_masks": all_masks,
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
