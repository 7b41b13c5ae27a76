"""The plain reference of AGILE3D (Yue et al., ICLR 2024): the Res16UNet34C
sparse UNet and the click-as-query decoder, in plain torch over the
reference's own voxels (``reference/sparse.py``). It imports nothing of
the program. Weights are a dict under the published module names, which
the benchmark makes from the seed and hands to both sides.

Departures from the published model, each the program's as well: dense
attention only (the program chooses chunked forms above a size; the same
function); the decoder's background queries and the click queries are
padded to a click bucket with masked slots (the masked keys add exactly
zero to every softmax).

Precision: each field of ``Precision`` is "f32" (TF32 off), "bf16" (each
matmul's two operands rounded to bfloat16, the products summed in f32),
"tf32" (TF32 on) or "fp8" (the operands rounded to float8 e4m3 with one
scale per tensor, the sums in f32). ``banded`` is the precision of the
convs that the published routing of the port sends to its banded kernels
(the k5 stem in eval; the k3 convs of 86 or more input channels at the two
finest levels), ``backbone`` that of the other convs. The reference runs
at "f32" throughout; the controls of the comparison that decides
``correct`` run one step below what the configuration states.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.sparse import Level

NEG_INF = -1e9
EPS = 1e-5


class Precision(NamedTuple):
    backbone: str = "f32"
    banded: str = "f32"
    decoder: str = "f32"


def _quantize(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x rounded to the mode's operand type, as float32."""
    x = x.float()
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "fp8":
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s
    return x


class _RoundedMM(torch.autograd.Function):
    """a @ b on operands rounded to ``mode``, and in the backward the
    incoming gradient rounded too: a product whose every pass takes
    operands of that type, as the port's banded kernels take bf16 ones
    forward and back."""

    @staticmethod
    def forward(ctx, a, b, mode):
        a, b = _quantize(a, mode), _quantize(b, mode)
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _quantize(g, ctx.mode)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g, None


def _rounded_einsum(eq, a, b, mode):
    """einsum on operands rounded to ``mode`` (no gradient: the decoder's
    attention products run without one wherever the reference rounds
    them)."""
    return torch.einsum(eq, _quantize(a, mode), _quantize(b, mode))


class MM:
    """Matrix products at one precision."""

    def __init__(self, mode: str):
        if mode not in ("f32", "bf16", "tf32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def __call__(self, eq_or_a, a, b=None):
        rounded = self.mode in ("bf16", "fp8")
        if b is None:   # a @ b form: (a, b)
            if rounded:
                return _RoundedMM.apply(eq_or_a, a, self.mode)
            with _tf32(self.mode == "tf32"):
                return eq_or_a @ a
        if rounded:
            return _rounded_einsum(eq_or_a, a, b, self.mode)
        with _tf32(self.mode == "tf32"):
            return torch.einsum(eq_or_a, a, b)


class _tf32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


# ---------------------------------------------------------------- weights

def param_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter and buffer the
    published model holds, under its module names. init: "uniform" (+-
    scale), "normal" (times scale), "one", "zero"."""
    bb, dec = cfg["backbone"], cfg["decoder"]
    planes, layers = bb["planes"], bb["layers"]
    d0, cin0, k1 = bb["init_dim"], bb["in_channels"], bb["conv1_kernel_size"]
    spec = []

    def conv(name, kvol, cin, cout):
        shape = (kvol, cin, cout) if kvol > 1 else (cin, cout)
        spec.append((name + ".kernel", shape, "uniform",
                     (cin * kvol) ** -0.5))

    def bn(name, c):
        spec.extend([(f"{name}.bn.weight", (c,), "one", 0.0),
                     (f"{name}.bn.bias", (c,), "zero", 0.0),
                     (f"{name}.bn.running_mean", (c,), "zero", 0.0),
                     (f"{name}.bn.running_var", (c,), "one", 0.0)])

    def stage(name, cin, p, n):
        for b in range(n):
            ci = cin if b == 0 else p
            conv(f"{name}.{b}.conv1", 27, ci, p)
            bn(f"{name}.{b}.norm1", p)
            conv(f"{name}.{b}.conv2", 27, p, p)
            bn(f"{name}.{b}.norm2", p)
            if ci != p:
                conv(f"{name}.{b}.downsample.0", 1, ci, p)
                bn(f"{name}.{b}.downsample.1", p)

    pre = "backbone."
    conv(pre + "conv0p1s1", k1 ** 3, cin0, d0)
    bn(pre + "bn0", d0)
    down_in = d0
    for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                              "conv4p8s2")):
        conv(pre + name, 8, down_in, down_in)
        bn(f"{pre}bn{i + 1}", down_in)
        stage(f"{pre}block{i + 1}", down_in, planes[i], layers[i])
        down_in = planes[i]
    skips = [planes[2], planes[1], planes[0], d0]
    tr_in = planes[3]
    for j, name in enumerate(("convtr4p16s2", "convtr5p8s2", "convtr6p4s2",
                              "convtr7p2s2")):
        i = 4 + j
        conv(pre + name, 8, tr_in, planes[i])
        bn(f"{pre}bntr{i}", planes[i])
        stage(f"{pre}block{i + 1}", planes[i] + skips[j], planes[i],
              layers[i])
        tr_in = planes[i]

    c, f = dec["hidden_dim"], dec["dim_feedforward"]
    conv("lin_squeeze_head", 1, planes[7], c)
    spec.append(("lin_squeeze_head.bias", (c,), "uniform", planes[7] ** -0.5))
    spec.append(("bg_query_feat.weight", (dec["num_bg_queries"], c),
                 "normal", 1.0))
    spec.append(("bg_query_pos.weight", (dec["num_bg_queries"], c),
                 "normal", 1.0))
    for k in (0, 2):
        spec.append((f"mask_embed_head.{k}.weight", (c, c), "uniform",
                     c ** -0.5))
        spec.append((f"mask_embed_head.{k}.bias", (c,), "uniform", c ** -0.5))
    spec.extend([("decoder_norm.weight", (c,), "one", 0.0),
                 ("decoder_norm.bias", (c,), "zero", 0.0)])
    spec.append(("pos_enc.gauss_B", (3, c // 2), "normal",
                 dec["gauss_scale"]))
    xav = (6.0 / (2 * c)) ** 0.5
    for d in range(dec["num_decoders"]):
        for i in range(len(dec["hlevels"])):
            for kind, attr in (("c2s_attention", "multihead_attn"),
                               ("c2c_attention", "self_attn"),
                               ("s2c_attention", "multihead_attn")):
                p = f"{kind}.{d}.{i}."
                spec.extend([
                    (p + attr + ".in_proj_weight", (3 * c, c), "uniform", xav),
                    (p + attr + ".in_proj_bias", (3 * c,), "zero", 0.0),
                    (p + attr + ".out_proj.weight", (c, c), "uniform", xav),
                    (p + attr + ".out_proj.bias", (c,), "zero", 0.0),
                    (p + "norm.weight", (c,), "one", 0.0),
                    (p + "norm.bias", (c,), "zero", 0.0)])
            p = f"ffn_attention.{d}.{i}."
            spec.extend([
                (p + "linear1.weight", (f, c), "uniform",
                 (6.0 / (c + f)) ** 0.5),
                (p + "linear1.bias", (f,), "uniform", c ** -0.5),
                (p + "linear2.weight", (c, f), "uniform",
                 (6.0 / (c + f)) ** 0.5),
                (p + "linear2.bias", (c,), "uniform", f ** -0.5),
                (p + "norm.weight", (c,), "one", 0.0),
                (p + "norm.bias", (c,), "zero", 0.0)])
    return spec


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight from ``seed`` on ``device`` in two draws (one uniform,
    one normal buffer) cut into the leaves."""
    spec = param_spec(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    n_u = sum(math.prod(s) for _, s, k, _ in spec if k == "uniform")
    n_n = sum(math.prod(s) for _, s, k, _ in spec if k == "normal")
    u = torch.rand(n_u, generator=g, device=device) * 2 - 1
    z = torch.randn(n_n, generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "uniform":
            t = u[iu:iu + n].view(shape) * scale
            iu += n
        elif kind == "normal":
            t = z[iz:iz + n].view(shape) * scale
            iz += n
        else:
            t = torch.full(shape, 1.0 if kind == "one" else 0.0,
                           device=device)
        out[name] = t.contiguous()
    return out


# ---------------------------------------------------------------- backbone

def _gather(x, idx):
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])[idx]


def conv(x, nbr, w, mm):
    """out[m] = sum_k x[nbr[m, k]] @ w[k], absent neighbours add 0."""
    out = mm(_gather(x, nbr[:, 0]), w[0])
    for k in range(1, w.shape[0]):
        out = out + mm(_gather(x, nbr[:, k]), w[k])
    return out


def conv_up(x, parent, child, w, mm):
    """Transposed kernel-2 stride-2 conv: a fine row gets its parent's row
    through the kernel element of its position in the parent."""
    g = x[parent]
    out = torch.zeros((len(parent), w.shape[2]), device=x.device)
    for k in range(8):
        out = torch.where((child == k)[:, None], mm(g, w[k]), out)
    return out


def batch_norm(x, w, name, stats):
    """Eval: running statistics; training (``stats`` a dict): the batch's
    mean and biased variance, the new running statistics (momentum 0.02,
    unbiased variance) recorded in ``stats``."""
    p = name + ".bn."
    if stats is None:
        y = (x - w[p + "running_mean"]) * torch.rsqrt(
            w[p + "running_var"] + EPS)
    else:
        mean = x.mean(0)
        d = x - mean
        var = (d * d).mean(0)
        n = x.shape[0]
        with torch.no_grad():
            stats[name] = (0.98 * w[p + "running_mean"] + 0.02 * mean,
                           0.98 * w[p + "running_var"]
                           + 0.02 * var * n / max(n - 1, 1))
        y = d * torch.rsqrt(var + EPS)
    return y * w[p + "weight"] + w[p + "bias"]


def backbone(w, lv: list[Level], feats, prec: Precision = Precision(),
             stats=None, checkpoint=False):
    """The stride-1 features [N0, planes[7]] of Res16UNet34C."""
    mm = MM(prec.backbone)
    mm_banded = MM(prec.banded)
    pre = "backbone."

    def run(fn, *args):
        if checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    def block(name, x, nbr, fine):
        def k3(x, kernel):
            return conv(x, nbr, kernel,
                        mm_banded if fine and x.shape[1] >= 86 else mm)

        def body(x):
            out = torch.relu(batch_norm(k3(x, w[name + ".conv1.kernel"]), w,
                                        name + ".norm1", stats))
            out = batch_norm(k3(out, w[name + ".conv2.kernel"]), w,
                             name + ".norm2", stats)
            res = x
            if name + ".downsample.0.kernel" in w:
                res = batch_norm(mm(x, w[name + ".downsample.0.kernel"]), w,
                                 name + ".downsample.1", stats)
            return torch.relu(out + res)
        return run(body, x)

    def stage(i, x, level_idx):
        b = 0
        while f"{pre}block{i}.{b}.conv1.kernel" in w:
            x = block(f"{pre}block{i}.{b}", x, lv[level_idx].k3,
                      level_idx < 2)
            b += 1
        return x

    stem_mm = mm if stats is not None else mm_banded
    out = torch.relu(batch_norm(run(conv, feats, lv[0].k5,
                                    w[pre + "conv0p1s1.kernel"], stem_mm),
                                w, pre + "bn0", stats))
    skips = [out]
    for i, name in enumerate(("conv1p1s2", "conv2p2s2", "conv3p4s2",
                              "conv4p8s2")):
        out = conv(out, lv[i].down, w[pre + name + ".kernel"], mm)
        out = torch.relu(batch_norm(out, w, f"{pre}bn{i + 1}", stats))
        out = stage(i + 1, out, i + 1)
        skips.append(out)
    for j, name in enumerate(("convtr4p16s2", "convtr5p8s2", "convtr6p4s2",
                              "convtr7p2s2")):
        i, tgt = 4 + j, 3 - j
        out = conv_up(out, lv[tgt].parent, lv[tgt].child,
                      w[pre + name + ".kernel"], mm)
        out = torch.relu(batch_norm(out, w, f"{pre}bntr{i}", stats))
        out = torch.cat([out, skips[tgt]], dim=1)
        out = stage(i + 1, out, tgt)
    return out


# ---------------------------------------------------------------- decoder

class Scene(NamedTuple):
    feat: torch.Tensor    # [B, N, C] squeezed features, 0 on pad rows
    pos: torch.Tensor     # [B, N, C] positional encoding of each voxel
    valid: torch.Tensor   # bool [B, N]
    raw: torch.Tensor     # [B, N, 3] each voxel's first point
    cmin: torch.Tensor    # [B, 3]
    cmax: torch.Tensor    # [B, 3]


def fourier(xyz, gauss_b, cmin, cmax):
    diff = cmax - cmin
    diff = torch.where(diff == 0, torch.ones_like(diff), diff)
    proj = ((xyz - cmin) / diff * (2 * math.pi)) @ gauss_b
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def time_table(d: int, length: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((length, d), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def scene_features(w, fmap, rows: list[torch.Tensor], raw: torch.Tensor):
    """The decoder's inputs per sample. fmap [N0, C] stride-1 features of
    the whole batch; rows[b] the level-0 rows of sample b (its voxels in
    key order); raw [N0, 3]."""
    sq = fmap @ w["lin_squeeze_head.kernel"] + w["lin_squeeze_head.bias"]
    b, n = len(rows), max(len(r) for r in rows)
    c = sq.shape[1]
    dev = sq.device
    feat = torch.zeros((b, n, c), device=dev)
    rawb = torch.zeros((b, n, 3), device=dev)
    valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for i, r in enumerate(rows):
        feat[i, :len(r)] = sq[r]
        rawb[i, :len(r)] = raw[r]
        valid[i, :len(r)] = True
    big = torch.tensor(3.4e38, device=dev)
    cmin = torch.where(valid[..., None], rawb, big).amin(1)
    cmax = torch.where(valid[..., None], rawb, -big).amax(1)
    pos = fourier(rawb, w["pos_enc.gauss_B"], cmin[:, None], cmax[:, None])
    pos = torch.where(valid[..., None], pos, 0.0)
    return Scene(feat, pos, valid, rawb, cmin, cmax)


def _ln(x, w, name):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * w[name + ".weight"] \
        + w[name + ".bias"]


def attention(w, name, q_in, k_in, v_in, bias, heads, mm):
    """torch's nn.MultiheadAttention (packed in-projection) with an
    additive bias [B, Lq or 1, Lk]."""
    wq, wk, wv = w[name + ".in_proj_weight"].chunk(3)
    bq, bk, bv = w[name + ".in_proj_bias"].chunk(3)
    b, lq, e = q_in.shape
    hd = e // heads
    q = (mm(q_in, wq.T) + bq).view(b, lq, heads, hd) * hd ** -0.5
    k = (mm(k_in, wk.T) + bk).view(b, -1, heads, hd)
    v = (mm(v_in, wv.T) + bv).view(b, -1, heads, hd)
    logits = mm("bqhd,bkhd->bhqk", q, k) + bias[:, None]
    out = mm("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    return mm(out.reshape(b, lq, e), w[name + ".out_proj.weight"].T) \
        + w[name + ".out_proj.bias"]


def decoder(w, cfg: dict, scene: Scene, vox, obj, tim, num_obj,
            prec: Precision = Precision(), feedback=None):
    """All refinement rounds for click tables vox / obj / tim [B, MC]
    (vox -1 = unused slot). Returns the mask logits of every round, [R, B,
    N, 1 + max_objects], NEG_INF on object columns past ``num_obj`` [B].

    A round's attention masks follow the labels of the round before it (a
    hard argmax), so two computations that round differently can part
    for good at one near tie. ``feedback`` [R - 1, B, N] (-1 on pad rows)
    gives the labels each round hands the next in place of this
    computation's own: the reference follows another computation's rounds
    step by step and judges each."""
    dec = cfg["decoder"]
    mm = MM(prec.decoder)
    heads, nbq = dec["num_heads"], dec["num_bg_queries"]
    b, n, c = scene.feat.shape
    dev = scene.feat.device
    n_cols = 1 + dec["max_fg_objects"]
    click_valid = vox >= 0
    safe = vox.clamp(0, n - 1).long()
    cfeat = torch.gather(scene.feat, 1, safe[..., None].expand(-1, -1, c))
    cfeat = torch.where(click_valid[..., None], cfeat, 0.0)
    cxyz = torch.gather(scene.raw, 1, safe[..., None].expand(-1, -1, 3))
    cpos = fourier(cxyz, w["pos_enc.gauss_B"], scene.cmin[:, None],
                   scene.cmax[:, None])
    table = time_table(c, dec["time_table_len"], dev)
    cpos = cpos + table[tim.clamp(0, table.shape[0] - 1).long()]
    cpos = torch.where(click_valid[..., None], cpos, 0.0)
    queries = torch.cat([w["bg_query_feat.weight"][None].expand(b, -1, -1),
                         cfeat], 1)
    qpos = torch.cat([w["bg_query_pos.weight"][None].expand(b, -1, -1),
                      cpos], 1)
    qobj = torch.cat([torch.zeros((b, nbq), dtype=torch.long, device=dev),
                      obj.long()], 1).clamp(0, n_cols - 1)
    qvalid = torch.cat([torch.ones((b, nbq), dtype=torch.bool, device=dev),
                        click_valid], 1)
    key_bias = torch.where(qvalid, 0.0, NEG_INF)[:, None, :]
    vox_bias = torch.where(scene.valid, 0.0, NEG_INF)[:, None, :]
    col_valid = (torch.arange(n_cols, device=dev)[None]
                 <= num_obj.to(dev)[:, None])
    src = scene.feat
    labels = torch.zeros((b, n), dtype=torch.long, device=dev)
    present = torch.zeros((b, n_cols), dtype=torch.bool, device=dev)
    rounds = []
    for d in range(dec["num_decoders"]):
        for i in range(len(dec["hlevels"])):
            sel = torch.gather(present, 1, qobj)
            mism = labels[:, None, :] != qobj[:, :, None]
            c2s_bias = torch.where(sel[..., None] & mism, NEG_INF, 0.0) \
                + vox_bias
            p = f"c2s_attention.{d}.{i}"
            queries = _ln(queries + attention(
                w, p + ".multihead_attn", queries + qpos, src + scene.pos,
                src, c2s_bias, heads, mm), w, p + ".norm")
            p = f"c2c_attention.{d}.{i}"
            queries = _ln(queries + attention(
                w, p + ".self_attn", queries + qpos, queries + qpos, queries,
                key_bias, heads, mm), w, p + ".norm")
            p = f"ffn_attention.{d}.{i}"
            h = torch.relu(mm(queries, w[p + ".linear1.weight"].T)
                           + w[p + ".linear1.bias"])
            queries = _ln(queries + mm(h, w[p + ".linear2.weight"].T)
                          + w[p + ".linear2.bias"], w, p + ".norm")
            p = f"s2c_attention.{d}.{i}"
            src = _ln(src + attention(
                w, p + ".multihead_attn", src + scene.pos, queries + qpos,
                queries, key_bias, heads, mm), w, p + ".norm")
            # mask head
            qn = _ln(queries, w, "decoder_norm")
            emb = torch.relu(mm(qn, w["mask_embed_head.0.weight"].T)
                             + w["mask_embed_head.0.bias"])
            emb = mm(emb, w["mask_embed_head.2.weight"].T) \
                + w["mask_embed_head.2.bias"]
            logits = mm("bnc,bqc->bnq", src, emb)
            cols = [torch.where(((qobj == o) & qvalid)[:, None, :], logits,
                                NEG_INF).amax(-1) for o in range(n_cols)]
            out = torch.where(col_valid[:, None, :], torch.stack(cols, -1),
                              NEG_INF)
            rounds.append(out)
            labels = torch.where(scene.valid, out.argmax(-1), -1)
            if feedback is not None and len(rounds) <= len(feedback):
                labels = feedback[len(rounds) - 1].long()
            present = (labels[:, None, :]
                       == torch.arange(n_cols, device=dev)[None, :, None]
                       ).any(-1)
    return torch.stack(rounds)
