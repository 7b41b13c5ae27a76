"""Voxel-axis ("sequence") parallel decoder over the mesh's ``sp`` axis
(counterpart of the JAX package's ``parallel/sp.py``).

Attention is N x Q with a small Q, so the voxel axis is sharded and the
queries are replicated on every rank:

  * click-to-scene attention: keys and values sharded; each rank reduces
    its keys to the online softmax's (m, l, acc) (``ops/attention.py::
    online_softmax``, in chunks picked from the PER-RANK row count), then
    one ``pmax`` and two ``psum``s combine them;
  * click-to-click attention and the FFN: replicated;
  * scene-to-click attention and the mask head: row-local;
  * the click features and coordinates (one ``psum`` each of a masked
    gather) and the mask head's "object present" (one ``psum``) are the
    other cross-rank reductions.

Each rank holds the rows ``[r L, (r + 1) L)`` of the scene and gets the
masks of its rows; the round bias is rebuilt per key chunk from the compact
(labels, present) state, as in the one-process decoder
(``models/agile3d.py::_round_bias_chunk``), and under the bf16 decoder the
round's queries and voxel features go back to bf16 at its end. Eval only:
no gradient, no dropout.
"""

from __future__ import annotations

import torch

from agile3d_torch.models.agile3d import (
    Agile3D,
    ClickState,
    SceneFeatures,
    _pick_attn_chunk,
    _round_bias_chunk,
    _where0,
)
from agile3d_torch.ops.attention import (
    NEG_INF,
    matmul,
    online_softmax,
    project_qkv,
)
from agile3d_torch.ops.norm import layer_norm
from agile3d_torch.parallel.mesh import Axis, axis_index, pmax, psum


def _mha_sharded_keys(attn, q_in, k_in, v_in, bias_fn, axis: Axis,
                      chunk: int):
    """``attn`` (a ``MultiheadAttention``) with the keys and values sharded
    over ``axis``: the distributed softmax. ``bias_fn(start, size)`` gives
    the bias of the rank's keys [start, start + size)."""
    b, lq, e = q_in.shape
    q, k, v = project_qkv(q_in, k_in, v_in, attn.num_heads,
                          attn.in_proj_weight, attn.in_proj_bias)
    m_loc, l_loc, acc_loc = online_softmax(q, k, v, chunk or k.shape[1],
                                           bias_fn=bias_fn)
    m = pmax(m_loc, axis)                                       # [b, h, q]
    corr = torch.exp(m_loc - m)
    denom = psum(l_loc * corr, axis)
    num = psum(acc_loc * corr[..., None], axis)
    out = num / torch.clamp(denom, min=1e-30)[..., None]
    out = out.transpose(1, 2).reshape(b, lq, e)
    return matmul(out, attn.out_proj.weight.T) + attn.out_proj.bias


def _cross_attn_sharded_keys(layer, tgt, memory_l, *, pos_l, query_pos,
                             bias_fn, axis: Axis, chunk: int):
    """A ``CrossAttentionLayer`` (post- or pre-norm) whose memory axis is
    sharded."""
    k_in = memory_l + pos_l

    def attend(q):
        return _mha_sharded_keys(layer.multihead_attn, q, k_in, memory_l,
                                 bias_fn, axis, chunk)

    norm = layer.norm
    if layer.pre_norm:
        t2 = layer_norm(tgt, norm.weight, norm.bias)
        return tgt + attend(t2 + query_pos)
    return layer_norm(tgt + attend(tgt + query_pos), norm.weight, norm.bias)


def _sp_mask_module(w, queries, src_l, query_obj, query_valid, col_valid,
                    vox_valid_l, axis: Axis):
    """The row-local mask head: (out [B, Nl, 1+K], labels [B, Nl], present
    [B, 1+K] over every rank, the one cross-rank ``psum``)."""
    out, labels, present_l = Agile3D._mask_module(
        w, queries, src_l, query_obj, query_valid, col_valid, vox_valid_l)
    present = psum(present_l.to(torch.int32), axis) > 0
    return out, labels, present


@torch.no_grad()
def forward_mask_local(model: Agile3D, scene_l: SceneFeatures,
                       clicks: ClickState, num_obj: torch.Tensor,
                       axis: Axis) -> torch.Tensor:
    """One ``forward_mask`` pass with the voxel axis sharded over ``axis``,
    run by every rank of it at once. ``scene_l``: this rank's rows of
    ``mask_feat``, ``pos_pcd``, ``vox_valid`` and ``raw``, and the whole
    scene's ``cmin`` / ``cmax``; ``clicks`` in global rows. Returns the
    per-round masks [R, B, Nl, 1+K] of this rank's rows (f32)."""
    cfg = model.cfg
    w = model._decoder_weights()
    if w is not model:
        scene_l = scene_l._replace(
            mask_feat=scene_l.mask_feat.to(torch.bfloat16),
            pos_pcd=scene_l.pos_pcd.to(torch.bfloat16))
    mask_feat_l, pos_l, valid_l = (scene_l.mask_feat, scene_l.pos_pcd,
                                   scene_l.vox_valid)
    b, nl, c = mask_feat_l.shape
    nbq, heads = cfg.num_bg_queries, cfg.num_heads
    dev = mask_feat_l.device
    lo = axis_index(axis) * nl

    # the click features and coordinates, one psum each of a masked gather
    click_valid = clicks.vox >= 0
    local = clicks.vox.long() - lo
    in_shard = click_valid & (local >= 0) & (local < nl)
    safe = local.clamp(0, nl - 1)
    cfeat = torch.gather(mask_feat_l, 1, safe[..., None].expand(-1, -1, c))
    cfeat = psum(_where0(in_shard[..., None], cfeat), axis)
    cxyz = torch.gather(scene_l.raw, 1, safe[..., None].expand(-1, -1, 3))
    cxyz = psum(_where0(in_shard[..., None], cxyz), axis)
    cpos = model._pos(cxyz, scene_l.cmin[:, None, :],
                      scene_l.cmax[:, None, :], w.pos_enc.gauss_B)
    t_safe = clicks.time.clamp(0, w.time_pe.shape[0] - 1).long()
    cpos = _where0(click_valid[..., None], cpos + w.time_pe[t_safe])
    cfeat = _where0(click_valid[..., None], cfeat)

    queries = torch.cat([w.bg_query_feat.weight[None].expand(b, -1, -1),
                         cfeat], dim=1)
    query_pos = torch.cat([w.bg_query_pos.weight[None].expand(b, -1, -1),
                           cpos], dim=1)
    query_obj = torch.cat([torch.zeros((b, nbq), dtype=torch.long, device=dev),
                           clicks.obj.long()], dim=1)
    query_valid = torch.cat([torch.ones((b, nbq), dtype=torch.bool,
                                        device=dev), click_valid], dim=1)
    zero = torch.zeros((), device=dev)
    q_key_bias = torch.where(query_valid, zero,
                             torch.full((), NEG_INF, device=dev))[:, None, :]
    n_cols = 1 + cfg.max_fg_objects
    col_valid = (torch.arange(n_cols, device=dev)[None, :]
                 <= num_obj.to(dev)[:, None])
    safe_obj = query_obj.clamp(0, n_cols - 1)
    # the chunk from this rank's rows, so that its logits stay bounded too
    chunk = _pick_attn_chunk(nl, b * queries.shape[1] * nl * heads, cfg)
    cdt = mask_feat_l.dtype

    src = mask_feat_l
    labels = torch.zeros((b, nl), dtype=torch.long, device=dev)
    present = torch.zeros((b, n_cols), dtype=torch.bool, device=dev)
    preds = []
    n_slots = len(cfg.hlevels)
    for r in range(cfg.num_decoders):
        d = 0 if cfg.shared_decoder else r
        for i in range(n_slots):
            bias_fn = _round_bias_chunk(labels, present, safe_obj, valid_l)
            queries = _cross_attn_sharded_keys(
                w.c2s_attention[d][i], queries, src, pos_l=pos_l,
                query_pos=query_pos, bias_fn=bias_fn, axis=axis, chunk=chunk)
            queries = w.c2c_attention[d][i](queries, query_pos=query_pos,
                                            attn_bias=q_key_bias)
            queries = w.ffn_attention[d][i](queries)
            src = w.s2c_attention[d][i](
                src, queries, pos=query_pos, query_pos=pos_l,
                attn_bias=q_key_bias, chunk_queries=chunk)
            masks, labels, present = _sp_mask_module(
                w, queries, src, query_obj, query_valid, col_valid, valid_l,
                axis)
            queries, src = queries.to(cdt), src.to(cdt)
            preds.append(masks)
    return torch.stack(preds)


def shard_rows(x: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of ``dim`` (which the axis size
    divides)."""
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"{n} rows do not divide over {axis.size} ranks")
    nl = n // axis.size
    return x.narrow(dim, axis_index(axis) * nl, nl)


def make_forward_mask_sp(mesh, cfg):
    """(forward_mask_sp, shard_scene) over the mesh's ``sp`` axis.
    ``forward_mask_sp(model, scene_l, clicks, num_obj)`` returns the
    one-process ``forward_mask``'s dict for this rank's rows;
    ``shard_scene(scene)`` cuts a whole scene's features to them."""
    if any(h != 4 for h in cfg.hlevels):
        raise NotImplementedError(
            "hlevels entries must all be 4 (the constraint of the one-process "
            "forward_mask)")
    axis = mesh["sp"]

    def forward_mask_sp(model, scene_l: SceneFeatures, clicks: ClickState,
                        num_obj: torch.Tensor) -> dict:
        all_masks = forward_mask_local(model, scene_l, clicks, num_obj, axis)
        return {"pred_masks": all_masks[-1],
                "aux_masks": all_masks[:-1] if len(all_masks) > 1 else None,
                "all_masks": all_masks}

    def shard_scene(scene: SceneFeatures) -> SceneFeatures:
        return scene._replace(
            mask_feat=shard_rows(scene.mask_feat, axis),
            pos_pcd=shard_rows(scene.pos_pcd, axis),
            vox_valid=shard_rows(scene.vox_valid, axis),
            raw=shard_rows(scene.raw, axis))

    return forward_mask_sp, shard_scene
