"""A plain float32 reference of the DeepSeek-V2 decoder, written from the
published description (arXiv:2405.04434, and the ``modeling_deepseek.py``
and ``config.json`` of deepseek-ai/DeepSeek-V2-Lite), for the port's tests.
It imports nothing of the port: one loop over layers, one over the held
experts, the textbook masked softmax.

- Multi-head latent attention without a q LoRA: q = x·Wq per head split
  into ``qk_nope`` and ``qk_rope`` columns; [c | k_rope] = x·Wkva, c
  RMS-normed (its own scale) and expanded by Wkvb into each head's k_nope
  and v; the rotary key is one for all heads. Rotary: YaRN frequencies,
  each (2i, 2i + 1) pair moved to (i, d/2 + i) before the half-split
  rotation; scores scaled by (qk_nope + qk_rope)^-0.5 · mscale(factor,
  mscale_all_dim)^2.
- Mixture of experts: softmax over all routed experts' logits (f32),
  greedy top-k, weights times the routed scaling factor (renormalised only
  with ``norm_topk_prob``); the shared experts' SwiGLU on every token plus,
  for the experts ``[offset, offset + held)`` only, each chosen expert's
  SwiGLU times its weight.
- The first ``first_k_dense_replace`` layers dense SwiGLU; pre-norm RMSNorm
  residual blocks; a final RMSNorm and the untied head.

Departures from the published model: the auxiliary balance loss is not
computed (a training loss the ASLM does not use), and the experts outside
the held share add nothing (another chip's part of the sum under expert
parallelism).

Parameters are taken as the port lays them out (plain dicts, dense kernels
``[in, out]``, the router ``[experts, hidden]``, held experts stacked
``[held, in, out]``) so the tests hand both the same tensors; ``cfg`` is any
object with the published config's attribute names.
"""

import math

import torch
import torch.nn.functional as F

NEG = -1e30


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def yarn_mscale(factor, mscale):
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(cfg):
    """The YaRN frequencies of the rotary dims (``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    orig = cfg.rope_original_max_position_embeddings

    def correction_dim(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dim - 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    inter = 1.0 / (cfg.rope_factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return inter * (1 - extra_mask) + extra * extra_mask


def rotary(x, positions, cfg):
    """``x [B, T, N, d]`` rotated at ``positions [B, T]``."""
    inv = yarn_inv_freq(cfg).to(x.device)
    ang = positions[..., None].float() * inv
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    cos = (torch.cat([ang.cos(), ang.cos()], -1) * m)[:, :, None, :]
    sin = (torch.cat([ang.sin(), ang.sin()], -1) * m)[:, :, None, :]
    b, t, n, d = x.shape
    x = x.view(b, t, n, d // 2, 2).transpose(4, 3).reshape(b, t, n, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def attention(p, cfg, x, positions, key_mask):
    """MLA, causal with key padding ``key_mask [B, T]``."""
    b, t, _ = x.shape
    nh, nope, rope, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
    q = (x @ p["q"]["kernel"]).view(b, t, nh, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = x @ p["kv_a"]["kernel"]
    c, k_rope = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    kv = (rms_norm(c, p["kv_norm"]["scale"], cfg.rms_norm_eps) @ p["kv_b"]["kernel"])
    kv = kv.view(b, t, nh, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_rope = rotary(q_rope, positions, cfg)
    k_rope = rotary(k_rope.view(b, t, 1, rope), positions, cfg).expand(b, t, nh, rope)
    qh = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
    kh = torch.cat([k_nope, k_rope], -1).transpose(1, 2)
    scale = (nope + rope) ** -0.5 * yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) ** 2
    scores = qh @ kh.transpose(-1, -2) * scale
    allowed = (torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
               & (key_mask[:, None, None, :] > 0))
    probs = torch.softmax(scores.masked_fill(~allowed, NEG), -1)
    ctx = (probs @ v.transpose(1, 2)).transpose(1, 2).reshape(b, t, nh * dv)
    return ctx @ p["out"]["kernel"]


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def mlp(p, x):
    return swiglu(x, p["gate"]["kernel"], p["up"]["kernel"], p["down"]["kernel"])


def moe(p, cfg, x, experts_held, expert_offset):
    """The shared experts plus the held experts' part of the routed sum."""
    scores = torch.softmax(x.float() @ p["router"]["weight"].float().t(), -1)
    weights, chosen = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.num_experts_per_tok > 1 and cfg.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * cfg.routed_scaling_factor
    out = mlp(p["shared"], x)
    e = p["experts"]
    for j in range(experts_held):
        w = (weights * (chosen == expert_offset + j)).sum(-1, keepdim=True)
        out = out + w * swiglu(x, e["gate"][j], e["up"][j], e["down"][j])
    return out


def decoder(params, cfg, embeds, key_mask, positions=None, experts_held=None,
            expert_offset=None):
    """Causal decoder over ``embeds [B, T, H]`` → f32 logits [B, T, V];
    the held share is the config's unless given."""
    b, t, _ = embeds.shape
    held = cfg.experts_held if experts_held is None else experts_held
    offset = cfg.expert_offset if expert_offset is None else expert_offset
    if positions is None:
        positions = torch.arange(t, device=embeds.device)[None].expand(b, t)
    h = embeds
    for idx, layer in enumerate(params["layers"]):
        h = h + attention(layer["attention"], cfg, rms_norm(h, layer["input_norm"]["scale"],
                                                            cfg.rms_norm_eps),
                          positions, key_mask)
        m = rms_norm(h, layer["post_attention_norm"]["scale"], cfg.rms_norm_eps)
        is_moe = idx >= cfg.first_k_dense_replace and idx % cfg.moe_layer_freq == 0
        h = h + (moe(layer["moe"], cfg, m, held, offset) if is_moe else mlp(layer["mlp"], m))
    h = rms_norm(h, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return h @ params["lm_head"]["kernel"]
