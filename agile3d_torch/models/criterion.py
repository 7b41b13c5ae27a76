"""Losses: click-weighted cross-entropy + multiclass soft dice, batched and
masked (counterpart of the JAX package's ``models/criterion.py``).

Everything is [B, N, 1+K] with validity masks. Padded object columns carry
NEG_INF logits, so their softmax mass is exactly 0.
"""

from __future__ import annotations

import torch

from agile3d_torch.config import LossConfig


def click_loss_weights(raw, vox_valid, click_vox, click_valid,
                       cfg: LossConfig) -> torch.Tensor:
    """Per-point loss weights: points near clicks weigh more,
    alpha + (beta - alpha) * (1 - min(d, tita) / tita) with d the distance
    to the nearest valid click. raw [B, N, 3]; click_vox [B, MC] voxel
    slots (-1 invalid). Returns [B, N], 0 on invalid points."""
    n = raw.shape[1]
    safe = click_vox.clamp(0, n - 1).long()
    cxyz = torch.gather(raw, 1, safe[..., None].expand(-1, -1, 3))  # [B, MC, 3]
    d2 = ((raw[:, :, None, :] - cxyz[:, None, :, :]) ** 2).sum(-1)
    inf = torch.full((), float("inf"), dtype=d2.dtype, device=d2.device)
    d2 = torch.where(click_valid[:, None, :], d2, inf)
    dmin = torch.sqrt(d2.amin(dim=-1))                             # [B, N]
    dmin = torch.where(torch.isfinite(dmin), dmin,
                       torch.full_like(dmin, cfg.w_tita))
    w = cfg.w_alpha + (cfg.w_beta - cfg.w_alpha) * (
        1.0 - dmin.clamp(max=cfg.w_tita) / cfg.w_tita)
    return torch.where(vox_valid, w, torch.zeros_like(w))


def _masked_mean(x, valid):
    return (x * valid).sum(dim=-1) / valid.sum(dim=-1).clamp(min=1)


def _bce(logits, target, weights, vox_valid):
    """Cross-entropy per point times its weight, mean over the valid
    points, mean over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, target[..., None].long())[..., 0]
    return _masked_mean(ce * weights, vox_valid).mean()


def _dice(logits, target, weights, vox_valid, n_cols, eps=1e-6):
    """The reference's dice telescopes to a per-point soft accuracy (its
    flatten(1).mean(1) runs over the class axis)."""
    p = torch.softmax(logits, dim=-1)
    p_gt = torch.gather(p, -1, target[..., None].long())[..., 0]
    num = 2.0 * p_gt / n_cols
    den = 2.0 / n_cols
    soft_iou = (num + eps) / (den + eps)
    loss = torch.where(num > eps, 1.0 - soft_iou, torch.zeros_like(num))
    return _masked_mean(loss * weights, vox_valid).mean()


def criterion_forward(all_masks, target, weights, vox_valid,
                      cfg: LossConfig = LossConfig()) -> dict:
    """all_masks [R, B, N, 1+K] logits of every decoder round; target
    [B, N] labels in [0, num_obj]; weights [B, N]; vox_valid bool [B, N].
    The final round gives loss_bce / loss_dice, earlier rounds
    loss_bce_i / loss_dice_i."""
    n_rounds, _, _, n_cols = all_masks.shape
    losses = {}
    fin = all_masks[-1]
    if "bce" in cfg.losses:
        losses["loss_bce"] = _bce(fin, target, weights, vox_valid)
    if "dice" in cfg.losses:
        losses["loss_dice"] = _dice(fin, target, weights, vox_valid, n_cols)
    if cfg.aux:
        for i in range(n_rounds - 1):
            if "bce" in cfg.losses:
                losses[f"loss_bce_{i}"] = _bce(all_masks[i], target, weights,
                                               vox_valid)
            if "dice" in cfg.losses:
                losses[f"loss_dice_{i}"] = _dice(all_masks[i], target,
                                                 weights, vox_valid, n_cols)
    return losses


def model_num_aux_rounds(model_cfg) -> int:
    """The decoder makes num_decoders * len(hlevels) predictions; all but
    the last are aux rounds."""
    return model_cfg.num_decoders * len(model_cfg.hlevels) - 1


def loss_weight_dict(cfg: LossConfig, num_aux_rounds: int) -> dict:
    wd = {"loss_bce": cfg.bce_loss_coef, "loss_dice": cfg.dice_loss_coef}
    if cfg.aux:
        for i in range(num_aux_rounds):
            wd[f"loss_bce_{i}"] = cfg.bce_loss_coef
            wd[f"loss_dice_{i}"] = cfg.dice_loss_coef
    return wd


def total_loss(losses: dict, weight_dict: dict):
    return sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
