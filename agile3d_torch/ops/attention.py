"""Multi-head attention and the decoder's cross/self/FFN layers
(counterpart of the JAX package's ``ops/attention.py``).

Parameters keep torch's nn.MultiheadAttention layout (packed
``in_proj_weight`` [3E, E], ``in_proj_bias``, ``out_proj``) and the
reference module names, so reference state dicts load as they are.
Positional embeddings are added to q/k only, layers are post-norm by
default, and an additive bias of ``NEG_INF`` masks a key (finite, so a
fully masked row degrades to uniform weights instead of NaN).

Three forms compute the same function:

  mha                  materialises the [B, H, Lq, Lk] logits;
  mha_chunked_keys     an online softmax over key chunks (the click-to-scene
                       direction, whose keys are the voxels); the bias comes
                       in [B, Lq, Lk] or from ``bias_fn(start, size)`` per
                       chunk, so the full bias need not exist;
  mha_chunked_queries  ``mha`` over query chunks (scene-to-click, whose
                       queries are the voxels).

The chunked forms are Python loops over tensors, differentiable by autograd,
with the JAX package's formulas: the running max starts at ``NEG_INF``, the
final divide is by ``max(l, 1e-30)``, and an axis that the chunk does not
divide falls back to ``mha``.

Mixed dtypes follow JAX's promotion, because the bf16 decoder policy
(``ModelConfig.decoder_dtype``) mixes bf16 weights with f32 activations: a
matmul or einsum of a bf16 and an f32 operand runs in f32 (torch would
refuse the pair), two bf16 operands stay bf16, and the online softmax's
statistics are f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from agile3d_torch.ops.norm import layer_norm

NEG_INF = -1e9


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def matmul(x, w):
    """``x @ w`` in the promoted dtype of the pair, as ``jnp.matmul``."""
    x, w = _promote(x, w)
    return x @ w


def _einsum(eq, a, b):
    a, b = _promote(a, b)
    return torch.einsum(eq, a, b)


def _heads(x, w, bias, num_heads):
    y = matmul(x, w.T) + bias
    return y.reshape(x.shape[0], x.shape[1], num_heads, -1)


def _query_heads(x, w, bias, num_heads):
    """Query heads times hd^-0.5, the factor rounded to the heads' dtype
    first as JAX rounds a Python scalar."""
    q = _heads(x, w, bias, num_heads)
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float64)
    return q * float(scale.to(q.dtype))


def _attend(q, k, v, attn_bias):
    """softmax(q k^T + bias) v over whole axes: q [B, Lq, H, hd], k / v
    [B, Lk, H, hd], attn_bias [B, Lq or 1, Lk] -> [B, Lq, H * hd]."""
    b, lq, h, hd = q.shape
    logits = _einsum("bqhd,bkhd->bhqk", q, k)
    if attn_bias is not None:
        logits = logits + attn_bias[:, None]
    attn = torch.softmax(logits, dim=-1)
    return _einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, lq, h * hd)


def _output(out, out_weight, out_bias):
    return matmul(out, out_weight.T) + out_bias


def mha(q_in, k_in, v_in, num_heads: int, in_proj_weight, in_proj_bias,
        out_weight, out_bias, attn_bias=None):
    """q_in [B, Lq, E]; k_in/v_in [B, Lk, E]; attn_bias [B, Lq, Lk] or
    [B, 1, Lk] additive, broadcast over heads."""
    w_q, w_k, w_v = in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = in_proj_bias.chunk(3, dim=0)
    q = _query_heads(q_in, w_q, b_q, num_heads)
    k = _heads(k_in, w_k, b_k, num_heads)
    v = _heads(v_in, w_v, b_v, num_heads)
    return _output(_attend(q, k, v, attn_bias), out_weight, out_bias)


def mha_chunked_keys(q_in, k_in, v_in, num_heads: int, in_proj_weight,
                     in_proj_bias, out_weight, out_bias, attn_bias=None,
                     chunk: int = 8192, bias_fn=None):
    """``mha`` by an online softmax over key chunks of ``chunk`` rows: the
    [B, H, Lq, Lk] logits never exist at once. The bias is ``attn_bias``
    [B, Lq, Lk] read chunk by chunk, or ``bias_fn(start, size) -> [B, Lq,
    size]`` for keys [start, start + size)."""
    b, lq, e = q_in.shape
    lk = k_in.shape[1]
    if lk % chunk != 0:
        if bias_fn is not None:
            attn_bias = bias_fn(0, lk)
        return mha(q_in, k_in, v_in, num_heads, in_proj_weight, in_proj_bias,
                   out_weight, out_bias, attn_bias)
    w_q, w_k, w_v = in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = in_proj_bias.chunk(3, dim=0)
    q = _query_heads(q_in, w_q, b_q, num_heads)
    k = _heads(k_in, w_k, b_k, num_heads)
    v = _heads(v_in, w_v, b_v, num_heads)
    hd = q.shape[-1]
    dev = q.device
    m = torch.full((b, num_heads, lq), NEG_INF, device=dev)
    l = torch.zeros((b, num_heads, lq), device=dev)
    acc = torch.zeros((b, num_heads, lq, hd), device=dev)
    for start in range(0, lk, chunk):
        keys = slice(start, start + chunk)
        logits = _einsum("bqhd,bkhd->bhqk", q, k[:, keys])
        if bias_fn is not None:
            logits = logits + bias_fn(start, chunk)[:, None]
        elif attn_bias is not None:
            logits = logits + attn_bias[:, None, :, keys]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + _einsum("bhqk,bkhd->bhqd", p,
                                               v[:, keys])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return _output(out.transpose(1, 2).reshape(b, lq, e), out_weight,
                   out_bias)


def mha_chunked_queries(q_in, k_in, v_in, num_heads: int, in_proj_weight,
                        in_proj_bias, out_weight, out_bias, attn_bias=None,
                        chunk: int = 8192):
    """``mha`` over query chunks of ``chunk`` rows, for a long query axis
    and a short key axis. attn_bias [B, Lq, Lk], or [B, 1, Lk]: one key
    bias for every query. The keys' projections are computed once."""
    b, lq, e = q_in.shape
    if lq % chunk != 0:
        return mha(q_in, k_in, v_in, num_heads, in_proj_weight, in_proj_bias,
                   out_weight, out_bias, attn_bias)
    w_q, w_k, w_v = in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = in_proj_bias.chunk(3, dim=0)
    k = _heads(k_in, w_k, b_k, num_heads)
    v = _heads(v_in, w_v, b_v, num_heads)
    shared = attn_bias is None or attn_bias.shape[1] == 1
    outs = []
    for start in range(0, lq, chunk):
        rows = slice(start, start + chunk)
        q = _query_heads(q_in[:, rows], w_q, b_q, num_heads)
        bias = attn_bias if shared else attn_bias[:, rows]
        outs.append(_output(_attend(q, k, v, bias), out_weight, out_bias))
    return torch.cat(outs, dim=1)


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, attn_bias=None, *, chunk_keys: int = 0,
                chunk_queries: int = 0, bias_fn=None):
        """Dense ``mha``, or a chunked form when ``chunk_keys`` /
        ``chunk_queries`` is set (``bias_fn`` with ``chunk_keys`` only)."""
        weights = (self.num_heads, self.in_proj_weight, self.in_proj_bias,
                   self.out_proj.weight, self.out_proj.bias)
        if chunk_keys:
            return mha_chunked_keys(q, k, v, *weights, attn_bias, chunk_keys,
                                    bias_fn)
        if chunk_queries:
            return mha_chunked_queries(q, k, v, *weights, attn_bias,
                                       chunk_queries)
        return mha(q, k, v, *weights, attn_bias)


def _ln(norm: nn.LayerNorm, x):
    return layer_norm(x, norm.weight, norm.bias)


class CrossAttentionLayer(nn.Module):
    """q = tgt + query_pos, k = memory + pos, v = memory; residual + norm.
    ``chunk_keys`` / ``chunk_queries`` select the chunked attention;
    ``attn_bias_fn(start, size)`` gives the key-chunk bias in place of
    ``attn_bias`` (``chunk_keys`` only)."""

    def __init__(self, d_model: int, num_heads: int, pre_norm: bool = False):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model)
        self.pre_norm = pre_norm

    def forward(self, tgt, memory, *, pos=None, query_pos=None, attn_bias=None,
                attn_bias_fn=None, chunk_keys: int = 0,
                chunk_queries: int = 0):
        k = memory if pos is None else memory + pos

        def attend(q):
            return self.multihead_attn(q, k, memory, attn_bias,
                                       chunk_keys=chunk_keys,
                                       chunk_queries=chunk_queries,
                                       bias_fn=attn_bias_fn)

        if self.pre_norm:
            t2 = _ln(self.norm, tgt)
            return tgt + attend(t2 if query_pos is None else t2 + query_pos)
        q = tgt if query_pos is None else tgt + query_pos
        return _ln(self.norm, tgt + attend(q))


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
        h = torch.relu(matmul(x, self.linear1.weight.T) + self.linear1.bias)
        return matmul(h, self.linear2.weight.T) + self.linear2.bias

    def forward(self, tgt):
        if self.pre_norm:
            return tgt + self._inner(_ln(self.norm, tgt))
        return _ln(self.norm, tgt + self._inner(tgt))
