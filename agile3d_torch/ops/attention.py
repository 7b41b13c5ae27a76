"""Multi-head attention and the decoder's cross/self/FFN layers
(counterpart of the JAX package's ``ops/attention.py``).

Parameters keep torch's nn.MultiheadAttention layout (packed
``in_proj_weight`` [3E, E], ``in_proj_bias``, ``out_proj``) and the
reference module names, so reference state dicts load as they are. The
forward is plain matmul + softmax in the caller's dtype: positional
embeddings are added to q/k only, layers are post-norm by default, and an
additive bias of ``NEG_INF`` masks a key (finite, so a fully masked row
degrades to uniform weights instead of NaN).

Dense attention only: the key- and query-chunked online-softmax forms of
the JAX package are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from agile3d_torch.ops.norm import layer_norm

NEG_INF = -1e9


def mha(q_in, k_in, v_in, num_heads: int, in_proj_weight, in_proj_bias,
        out_weight, out_bias, attn_bias=None):
    """q_in [B, Lq, E]; k_in/v_in [B, Lk, E]; attn_bias [B, Lq, Lk] or
    [B, 1, Lk] additive, broadcast over heads."""
    b, lq, e = q_in.shape
    hd = e // num_heads
    w_q, w_k, w_v = in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = in_proj_bias.chunk(3, dim=0)

    def proj(x, w, bias):
        return (x @ w.T + bias).reshape(x.shape[0], x.shape[1], num_heads, hd)

    q = proj(q_in, w_q, b_q) * (hd ** -0.5)
    k = proj(k_in, w_k, b_k)
    v = proj(v_in, w_v, b_v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if attn_bias is not None:
        logits = logits + attn_bias[:, None, :, :]
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, lq, e)
    return out @ out_weight.T + out_bias


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, attn_bias=None):
        return mha(q, k, v, self.num_heads, self.in_proj_weight,
                   self.in_proj_bias, self.out_proj.weight,
                   self.out_proj.bias, attn_bias)


def _ln(norm: nn.LayerNorm, x):
    return layer_norm(x, norm.weight, norm.bias)


class CrossAttentionLayer(nn.Module):
    """q = tgt + query_pos, k = memory + pos, v = memory; residual + norm."""

    def __init__(self, d_model: int, num_heads: int, pre_norm: bool = False):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model)
        self.pre_norm = pre_norm

    def forward(self, tgt, memory, *, pos=None, query_pos=None, attn_bias=None):
        k = memory if pos is None else memory + pos
        if self.pre_norm:
            t2 = _ln(self.norm, tgt)
            q = t2 if query_pos is None else t2 + query_pos
            return tgt + self.multihead_attn(q, k, memory, attn_bias)
        q = tgt if query_pos is None else tgt + query_pos
        return _ln(self.norm, tgt + self.multihead_attn(q, k, memory, attn_bias))


class SelfAttentionLayer(nn.Module):
    """q = k = tgt + query_pos, v = tgt; residual + norm."""

    def __init__(self, d_model: int, num_heads: int, pre_norm: bool = False):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model)
        self.pre_norm = pre_norm

    def forward(self, tgt, *, query_pos=None, attn_bias=None):
        if self.pre_norm:
            t2 = _ln(self.norm, tgt)
            q = t2 if query_pos is None else t2 + query_pos
            return tgt + self.self_attn(q, q, t2, attn_bias)
        q = tgt if query_pos is None else tgt + query_pos
        return _ln(self.norm, tgt + self.self_attn(q, q, tgt, attn_bias))


class FFNLayer(nn.Module):
    """linear -> relu -> linear; residual + norm."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 pre_norm: bool = False):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model)
        self.pre_norm = pre_norm

    def _inner(self, x):
        h = torch.relu(x @ self.linear1.weight.T + self.linear1.bias)
        return h @ self.linear2.weight.T + self.linear2.bias

    def forward(self, tgt):
        if self.pre_norm:
            return tgt + self._inner(_ln(self.norm, tgt))
        return _ln(self.norm, tgt + self._inner(tgt))
