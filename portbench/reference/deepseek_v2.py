"""The plain reference of DeepSeek-V2's decoder for the benchmark, in
float32 from the published description (arXiv:2405.04434; the
``modeling_deepseek.py`` and ``config.json`` of deepseek-ai/DeepSeek-V2-Lite),
importing nothing of the program: multi-head latent attention with YaRN
rotary, the dense first layer, and the expert layers with the routed
experts this chip holds (``experts_held`` from ``expert_offset``) plus the
shared experts. What the absent experts would add is left out, as on the
program's side; the balance loss is not computed (the ASLM's loss is the
caption cross-entropy). ``cfg`` is the configuration file (the published
keys at its top level).

Attention runs through :class:`LatentAttention`, which works through the
heads in chunks and recomputes the probabilities in its backward (as
``model.PlainAttention``, with q/k wider than v and the YaRN scale), so the
long-form LM fits on the card; each decoder layer is checkpointed (its
forward recomputed in the backward, the same f32 arithmetic), so the
float8 control's extra operand copies fit too. Each expert runs on the
tokens routed to it, found on the host. ``routes``, when given a list,
receives each expert layer's sorted top-k choices ``[N, k]`` of the
forward (not of the recompute).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import model as ref
from portbench.reference.model import NEG, Arith, head_chunk


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def rotary(x, positions, cfg):
    """``x [B, T, N, d]`` at ``positions [B, T]``: YaRN frequencies, each
    (2i, 2i + 1) pair moved to (i, d/2 + i), then the half-split rotation."""
    rs = cfg["rope_scaling"]
    dim, base, orig = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), \
        rs["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=x.device) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    inv = inter * ramp + extra * (1.0 - ramp)
    ang = positions[..., None].to(torch.float32) * inv
    m = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    cos = (torch.cat([ang.cos(), ang.cos()], -1) * m)[:, :, None, :]
    sin = (torch.cat([ang.sin(), ang.sin()], -1) * m)[:, :, None, :]
    b, t, n, d = x.shape
    x = x.view(b, t, n, d // 2, 2).transpose(4, 3).reshape(b, t, n, d)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1) * sin


class LatentAttention(torch.autograd.Function):
    """Causal softmax attention with key padding on q/k ``[B, T, H, DQK]``
    and v ``[B, T, H, DV]`` at score scale ``scale``, heads in chunks, the
    probabilities recomputed in the backward."""

    @staticmethod
    def _probs(q, k, allowed, h0, hc, scale):
        qh, kh = q[:, :, h0:h0 + hc].transpose(1, 2), k[:, :, h0:h0 + hc].transpose(1, 2)
        p = torch.softmax((qh @ kh.transpose(-1, -2) * scale).masked_fill(~allowed, NEG), -1)
        return torch.where(allowed.any(-1, keepdim=True), p, torch.zeros((), device=q.device)), \
            qh, kh

    @staticmethod
    def _allowed(key_mask, t):
        tri = torch.ones((t, t), dtype=torch.bool, device=key_mask.device).tril()
        return (key_mask[:, None, None, :] > 0) & tri[None, None]

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        b, t, h, _ = q.shape
        allowed = LatentAttention._allowed(key_mask, t)
        out = q.new_empty((b, t, h, v.shape[-1]))
        step = head_chunk(b, t, t, h)
        for h0 in range(0, h, step):
            hc = min(step, h - h0)
            p, _, _ = LatentAttention._probs(q, k, allowed, h0, hc, scale)
            out[:, :, h0:h0 + hc] = (p @ v[:, :, h0:h0 + hc].transpose(1, 2)).transpose(1, 2)
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask = ctx.saved_tensors
        b, t, h, _ = q.shape
        allowed = LatentAttention._allowed(key_mask, t)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        step = head_chunk(b, t, t, h)
        for h0 in range(0, h, step):
            hc = min(step, h - h0)
            heads = slice(h0, h0 + hc)
            p, qh, kh = LatentAttention._probs(q, k, allowed, h0, hc, ctx.scale)
            vh, doh = v[:, :, heads].transpose(1, 2), dout[:, :, heads].transpose(1, 2)
            dp = doh @ vh.transpose(-1, -2)
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[:, :, heads] = (ds @ kh * ctx.scale).transpose(1, 2)
            dk[:, :, heads] = (ds.transpose(-1, -2) @ qh * ctx.scale).transpose(1, 2)
            dv[:, :, heads] = (p.transpose(-1, -2) @ doh).transpose(1, 2)
        return dq, dk, dv, None, None


def attention(p, cfg, x, positions, key_mask, ar: Arith):
    b, t, _ = x.shape
    nh, nope, rope, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = ref.dense(x, p["q"], ar).view(b, t, nh, nope + rope)
    ckv = ref.dense(x, p["kv_a"], ar)
    c, k_rope = ckv[..., :rank], ckv[..., rank:]
    kv = ref.dense(ref.rms_norm(c, p["kv_norm"], cfg["rms_norm_eps"]), p["kv_b"], ar)
    kv = kv.view(b, t, nh, nope + dv)
    q = torch.cat([q[..., :nope], rotary(q[..., nope:], positions, cfg)], -1)
    k_rope = rotary(k_rope.view(b, t, 1, rope), positions, cfg).expand(b, t, nh, rope)
    k = torch.cat([kv[..., :nope], k_rope], -1)
    m = yarn_mscale(cfg["rope_scaling"]["factor"], cfg["rope_scaling"]["mscale_all_dim"])
    ctx = LatentAttention.apply(ar.op(q), ar.op(k), ar.op(kv[..., nope:]), key_mask,
                                (nope + rope) ** -0.5 * m * m)
    return ref.dense(ctx.reshape(b, t, nh * dv), p["out"], ar)


def swiglu(x, gate, up, down, ar: Arith):
    return torch.matmul(ar.op(F.silu(torch.matmul(ar.op(x), ar.op(gate)))
                              * torch.matmul(ar.op(x), ar.op(up))), ar.op(down))


def route(p, cfg, x, ar: Arith):
    """The router over all experts: ``(weights [N, k], chosen [N, k])``."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(torch.matmul(ar.op(x), ar.op(p["weight"]).t()), -1)
    weights, chosen = torch.topk(scores, k, dim=-1)
    if k > 1 and cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * cfg["routed_scaling_factor"], chosen


def routed(e, cfg, x, weights, chosen, ar: Arith, out):
    """``out`` plus the held experts' (``e``: stacked ``gate``, ``up``,
    ``down``) weighted outputs on the tokens ``chosen`` routes to them."""
    for j in range(cfg["experts_held"]):
        hit = chosen == cfg["expert_offset"] + j
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        w = (weights * hit).sum(-1)[rows, None]
        y = swiglu(x[rows], e["gate"][j], e["up"][j], e["down"][j], ar)
        out = out.index_add(0, rows, w * y)
    return out


def moe(p, cfg, x, ar: Arith, routes=None):
    """The shared experts on every token plus the held experts' weighted
    outputs on the tokens routed to them."""
    lead, h = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, h)
    weights, chosen = route(p["router"], cfg, x, ar)
    if routes is not None and torch._C._current_graph_task_id() == -1:
        routes.append(chosen.sort(-1).values.to(torch.int16))
    s = p["shared"]
    out = swiglu(x, s["gate"]["kernel"], s["up"]["kernel"], s["down"]["kernel"], ar)
    return routed(p["experts"], cfg, x, weights, chosen, ar, out).reshape(*lead, h)


def decoder(params, cfg, embeds, mask, positions, ar: Arith, head_from: int = 0, routes=None):
    """Causal decoder over ``embeds [B, T, H]`` with key mask ``mask [B, T]``
    → f32 logits of positions ``head_from ...``."""
    eps = cfg["rms_norm_eps"]

    def block(hidden, idx, layer):
        a = ref.rms_norm(hidden, layer["input_norm"], eps)
        hidden = hidden + attention(layer["attention"], cfg, a, positions, mask, ar)
        m = ref.rms_norm(hidden, layer["post_attention_norm"], eps)
        if idx >= cfg["first_k_dense_replace"] and idx % cfg["moe_layer_freq"] == 0:
            return hidden + moe(layer["moe"], cfg, m, ar, routes)
        d = layer["mlp"]
        return hidden + swiglu(m, d["gate"]["kernel"], d["up"]["kernel"], d["down"]["kernel"],
                               ar)

    hidden = embeds
    for idx, layer in enumerate(params["layers"]):
        hidden = checkpoint(block, hidden, idx, layer, use_reentrant=False)
    hidden = ref.rms_norm(hidden[:, head_from:], params["final_norm"], eps)
    return torch.matmul(ar.op(hidden), ar.op(params["lm_head"]["kernel"]))
