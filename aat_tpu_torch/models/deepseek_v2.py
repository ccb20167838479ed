"""DeepSeek-V2 causal LM decoder: multi-head latent attention (MLA) with
YaRN rotary, a fine-grained mixture of experts with shared experts, and
leading dense layers (DeepSeek-V2-Lite: arXiv:2405.04434 and its
``modeling_deepseek.py``). The JAX package has no counterpart.

Parameters are plain dictionaries of tensors, dense kernels ``[in, out]``
as in :mod:`~aat_tpu_torch.models.llama`; the router keeps the published
``[experts, hidden]`` layout and the held experts' kernels are stacked,
``[held, in, out]``.

Attention (no q LoRA, as in the Lite model): q = x·W_q split into 128
"nope" and 64 rotary columns a head; [c_kv | k_pe] = x·W_kv_a, c_kv
RMS-normed and expanded by W_kv_b into each head's 128-wide k_nope and
128-wide v; the rotary key k_pe (64 wide) is shared by all heads. Rotary
positions de-interleave each pair before the half-split rotation, as the
published code does. Scores are scaled by 192^-0.5·m², m the YaRN mscale of
``mscale_all_dim``. At T >= ``MIN_PALLAS_SEQ_LEN`` bf16 operands of the
no-cache route take the causal flash kernels with q/k 192 wide and v 128
wide (v is not padded); f32 operands and the KV-cache route compute the
plain masked softmax. The cache holds each layer's expanded k [B, H, L,
192] and v [B, H, L, 128] (the compressed latent cache is not ported).

Mixture of experts (layers past ``first_k_dense_replace``): the router
scores all ``n_routed_experts`` in f32 (softmax, greedy top-k, weights not
renormalised unless ``norm_topk_prob``, times ``routed_scaling_factor``).
This process holds experts ``[expert_offset, expert_offset +
experts_held)`` (one chip's share under expert parallelism) and adds only
their part of the routed sum; the shared experts run on every token. The
held experts' gate, up and down products each run as one grouped product
over a buffer of every (token, choice) pair sorted by held expert, the
pairs on other experts last, with the group offsets on the device: no
device-to-host copy, no dropped token, no capacity. The pairs past the
last group are masked to zero. Routed outputs are weighted and summed over
a token's choices in f32 and cast back, as published. The balance loss is
not computed (the ASLM's loss is the caption cross-entropy).

Parallelism: tensor, pipeline and sequence parallel routes are refused
(the trainer raises); data parallel and FSDP treat the tree as any other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._C._autograd import _profiler_enabled

from aat_tpu_torch.models.hubert import np_rng_from, run_remat
from aat_tpu_torch.models.llama import _dense, _rms_norm, causal_mask_bias, embed_tokens
from aat_tpu_torch.ops import attention as attn_ops
from aat_tpu_torch.utils import timing
from aat_tpu_torch.utils.port import to_tensors


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944  # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408  # one routed (or shared) expert's width
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 163840
    # YaRN (rope_scaling of the published config)
    rope_factor: float = 40.0
    rope_original_max_position_embeddings: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    tie_word_embeddings: bool = False
    # the routed experts this process holds: [expert_offset, + experts_held)
    experts_held: int = 64
    expert_offset: int = 0
    attention_impl: str = "xla"  # 'xla' | 'pallas' (causal flash kernels)
    remat: bool = False  # recompute decoder layers in the backward (no-cache route)
    remat_policy: str = "full"  # 'full' | 'dots' (see HubertConfig)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe_layer(self, idx: int) -> bool:
        return idx >= self.first_k_dense_replace and idx % self.moe_layer_freq == 0


def deepseek_v2_lite_config(experts_held: int = 64, expert_offset: int = 0) -> DeepseekV2Config:
    """deepseek-ai/DeepSeek-V2-Lite (15.7 B): 27 layers of width 2048, MLA
    16 x (128 + 64) / 128 with a rank-512 latent, layer 0 dense (10944),
    then 64 routed experts of 1408 (top-6) and 2 shared; vocabulary 102400,
    untied head, YaRN x40 over 4096 positions. ``experts_held`` /
    ``expert_offset``: this process's share of the routed experts."""
    return DeepseekV2Config(experts_held=experts_held, expert_offset=expert_offset,
                            attention_impl="pallas")


def tiny_test_config(experts_held: int = 4, expert_offset: int = 0) -> DeepseekV2Config:
    """CPU-test widths with the published structure: nope, rope and v
    widths all different, one dense layer then MoE layers, 8 routed experts
    (top-3), 2 shared."""
    return DeepseekV2Config(vocab_size=128, hidden_size=32, intermediate_size=48,
                            moe_intermediate_size=16, num_hidden_layers=3, num_attention_heads=4,
                            n_routed_experts=8, num_experts_per_tok=3, kv_lora_rank=24,
                            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
                            max_position_embeddings=4096, rope_original_max_position_embeddings=64,
                            rope_factor=4.0, experts_held=experts_held,
                            expert_offset=expert_offset)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_deepseek_v2_numpy(seed, config: DeepseekV2Config, std: float = 0.02) -> dict:
    """Normal(0, std) kernels and embeddings, unit norm scales; the held
    experts only. ``seed`` is an int or PRNG key words
    (:func:`~aat_tpu_torch.models.hubert.np_rng_from`)."""
    r = np_rng_from(seed)
    c, h = config, config.hidden_size

    def normal(*shape):
        return r.normal(0.0, std, shape).astype(np.float32)

    def dense(din, dout):
        return {"kernel": normal(din, dout)}

    def ones(d):
        return {"scale": np.ones((d,), np.float32)}

    def mlp(width):
        return {"gate": dense(h, width), "up": dense(h, width), "down": dense(width, h)}

    params = {"embed_tokens": {"embedding": normal(c.vocab_size, h)}, "layers": [],
              "final_norm": ones(h)}
    nh, e, w = c.num_attention_heads, c.experts_held, c.moe_intermediate_size
    for idx in range(c.num_hidden_layers):
        layer = {
            "input_norm": ones(h),
            "attention": {"q": dense(h, nh * c.qk_head_dim),
                          "kv_a": dense(h, c.kv_lora_rank + c.qk_rope_head_dim),
                          "kv_norm": ones(c.kv_lora_rank),
                          "kv_b": dense(c.kv_lora_rank, nh * (c.qk_nope_head_dim + c.v_head_dim)),
                          "out": dense(nh * c.v_head_dim, h)},
            "post_attention_norm": ones(h),
        }
        if c.is_moe_layer(idx):
            layer["moe"] = {"router": {"weight": normal(c.n_routed_experts, h)},
                            "experts": {"gate": normal(e, h, w), "up": normal(e, h, w),
                                        "down": normal(e, w, h)},
                            "shared": mlp(w * c.n_shared_experts)}
        else:
            layer["mlp"] = mlp(c.intermediate_size)
        params["layers"].append(layer)
    if not c.tie_word_embeddings:
        params["lm_head"] = dense(h, c.vocab_size)
    return params


def init_deepseek_v2_params(seed, config: DeepseekV2Config, device=None) -> dict:
    return to_tensors(init_deepseek_v2_numpy(seed, config), device)


# ---------------------------------------------------------------------------
# YaRN rotary
# ---------------------------------------------------------------------------


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_correction_range(config: DeepseekV2Config):
    """(low, high) dims of the ramp between interpolated and extrapolated
    frequencies: the dims whose wavelength turns ``beta_fast`` and
    ``beta_slow`` times over the original context, floored and ceiled."""
    dim, base = config.qk_rope_head_dim, config.rope_theta
    orig = config.rope_original_max_position_embeddings

    def dim_of(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(config.rope_beta_fast)), 0)
    high = min(math.ceil(dim_of(config.rope_beta_slow)), dim - 1)
    return low, high


def yarn_inv_freq(config: DeepseekV2Config, device=None) -> torch.Tensor:
    """[dim / 2] f32: extrapolated frequencies below ``low``, interpolated
    (divided by the factor) above ``high``, a linear ramp between."""
    dim = config.qk_rope_head_dim
    extra = 1.0 / (config.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                      device=device) / dim))
    inter = extra / config.rope_factor
    low, high = yarn_correction_range(config)
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / max(
        high - low, 0.001)
    mask = 1.0 - ramp.clamp(0.0, 1.0)
    return inter * (1.0 - mask) + extra * mask


def softmax_scale(config: DeepseekV2Config) -> float:
    """192^-0.5 · m², m the mscale of ``mscale_all_dim``."""
    m = yarn_mscale(config.rope_factor, config.rope_mscale_all_dim)
    return config.qk_head_dim ** -0.5 * m * m


def rope_cos_sin(positions: torch.Tensor, config: DeepseekV2Config):
    """positions [B, T] → cos/sin [B, T, dim] f32 (half-split layout), times
    the ratio of the two mscales."""
    freqs = positions[..., None].float() * yarn_inv_freq(config, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    mscale = (yarn_mscale(config.rope_factor, config.rope_mscale)
              / yarn_mscale(config.rope_factor, config.rope_mscale_all_dim))
    return torch.cos(emb) * mscale, torch.sin(emb) * mscale


def _rope(x, cos, sin):
    """x [B, T, N, d] at cos/sin [B, T, d]: each pair (2i, 2i+1)
    de-interleaved to (i, d/2 + i), then the half-split rotation, in f32."""
    b, t, n, d = x.shape
    x32 = x.float().reshape(b, t, n, d // 2, 2).transpose(-1, -2).reshape(b, t, n, d)
    rot = torch.cat([-x32[..., d // 2:], x32[..., : d // 2]], dim=-1)
    return (x32 * cos[:, :, None] + rot * sin[:, :, None]).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attention(p, config: DeepseekV2Config, x, cos, sin, mask_bias, kv_cache, cache_index,
               key_padding_mask=None):
    with timing.span("mla.attention", device=x.is_cuda):
        return _mla(p, config, x, cos, sin, mask_bias, kv_cache, cache_index, key_padding_mask)


def _mla(p, c: DeepseekV2Config, x, cos, sin, mask_bias, kv_cache, cache_index,
         key_padding_mask):
    b, t, _ = x.shape
    nh, nope, rope, dv = (c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim,
                          c.v_head_dim)
    q = _dense(x, p["q"]).reshape(b, t, nh, nope + rope)
    ckv, k_pe = _dense(x, p["kv_a"]).split([c.kv_lora_rank, rope], dim=-1)
    kv = _dense(_rms_norm(ckv, p["kv_norm"], c.rms_norm_eps), p["kv_b"])
    k_nope, v = kv.reshape(b, t, nh, nope + dv).split([nope, dv], dim=-1)
    q_pe = _rope(q[..., nope:], cos, sin)
    k_pe = _rope(k_pe.reshape(b, t, 1, rope), cos, sin)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, t, nh, rope)], dim=-1)
    scale = softmax_scale(c)

    if kv_cache is not None:
        ck, cv = kv_cache  # [B, H, L, 192], [B, H, L, 128], updated in place
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if torch.is_tensor(cache_index) and cache_index.ndim == 1:
            if t != 1:
                raise ValueError("vector cache_index requires single-token decode")
            bidx = torch.arange(b, device=x.device)
            ci = cache_index.to(device=x.device, dtype=torch.int64)
            ck[bidx, :, ci, :] = kt[:, :, 0, :].to(ck.dtype)
            cv[bidx, :, ci, :] = vt[:, :, 0, :].to(cv.dtype)
        else:
            i0 = int(cache_index)
            ck[:, :, i0 : i0 + t, :] = kt.to(ck.dtype)
            cv[:, :, i0 : i0 + t, :] = vt.to(cv.dtype)
        k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    elif (c.attention_impl == "pallas" and key_padding_mask is not None
          and x.dtype == torch.bfloat16 and t >= attn_ops.MIN_PALLAS_SEQ_LEN):
        ctx = attn_ops.flash_attention_bthd(q, k, v, key_padding_mask, True, scale)
        return _dense(ctx.reshape(b, t, nh * dv), p["out"])

    ct = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)).float() * scale
    probs = torch.softmax(scores + mask_bias, dim=-1).to(x.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(ct), v.to(ct)).to(x.dtype)
    return _dense(ctx.reshape(b, t, nh * dv), p["out"])


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


class _GroupedMatmul(torch.autograd.Function):
    """``y[r] = x[r] @ w[g]`` for the rows r of group g (groups end at
    ``offs``, on the device), one grouped product; rows past the last
    offset are zero. Its backward runs the input gradient as one grouped
    product and the weight gradient only when ``w`` needs one."""

    @staticmethod
    def forward(ctx, x, w, offs, live):
        ctx.save_for_backward(x if w.requires_grad else None, w, offs, live)
        return torch._grouped_mm(x, w, offs=offs).masked_fill_(~live, 0)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs, live = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch._grouped_mm(dy, w.transpose(-2, -1), offs=offs).masked_fill_(~live, 0)
        if ctx.needs_input_grad[1]:
            dw = torch._grouped_mm(x.t(), dy, offs=offs)
        return dx, dw, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                   live: torch.Tensor) -> torch.Tensor:
    """``x [N, in]`` rows in groups ending at ``offs [E]`` (int32, on the
    device) times ``w [E, in, out]``; ``live [N, 1]`` marks the rows before
    the last offset. One grouped product (``torch._grouped_mm``) for every
    dtype and device it takes."""
    return _GroupedMatmul.apply(x.contiguous(), w.to(x.dtype), offs, live)


def route(p, config: DeepseekV2Config, x: torch.Tensor):
    """Router over all experts: ``(weights [N, k] f32, experts [N, k])``."""
    logits = x.float() @ p["weight"].float().t()
    scores = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(scores, config.num_experts_per_tok, dim=-1)
    if config.num_experts_per_tok > 1 and config.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * config.routed_scaling_factor, experts


def _mlp(p, x):
    return _dense(F.silu(_dense(x, p["gate"])) * _dense(x, p["up"]), p["down"])


def _moe(p, config: DeepseekV2Config, x):
    """Shared experts on every token plus the held experts' part of the
    routed sum."""
    lead, h = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, h)
    n, k, e = flat.shape[0], config.num_experts_per_tok, config.experts_held
    # counted in the forward only, not again where remat recomputes it
    traced = _profiler_enabled() and torch._C._current_graph_task_id() == -1
    with timing.span("moe.route", device=x.is_cuda):
        weights, experts = route(p["router"], config, flat)
        local = experts - config.expert_offset
        held = (local >= 0) & (local < e)
        # every (token, choice) pair, sorted by held expert; the others last
        key = torch.where(held, local, e).reshape(-1)
        order = torch.argsort(key, stable=True)
        # (scatter_add: CUDA's bincount reads its largest key on the host)
        counts = torch.zeros(e + 1, dtype=torch.int64, device=x.device).scatter_add_(
            0, key, torch.ones_like(key))
        offs = torch.cumsum(counts[:e], 0).to(torch.int32)
        live = (torch.arange(n * k, device=x.device) < offs[-1])[:, None]
        pairs = flat[:, None, :].expand(n, k, h).reshape(n * k, h)[order]
        if traced:
            timing.count_device("moe.pairs", n * k)
            timing.count_device("moe.pairs_here", offs[-1])
    with timing.span("moe.experts", device=x.is_cuda):
        w = p["experts"]
        gate = grouped_matmul(pairs, w["gate"], offs, live)
        up = grouped_matmul(pairs, w["up"], offs, live)
        routed = grouped_matmul(F.silu(gate) * up, w["down"], offs, live)
        # back to (token, choice) order; weighted and summed over the
        # choices in f32, as published
        unsorted = torch.empty_like(routed).index_copy_(0, order, routed)
        combined = (unsorted.reshape(n, k, h).float()
                    * torch.where(held, weights, 0.0)[..., None]).sum(1).to(x.dtype)
    return (_mlp(p["shared"], flat) + combined).reshape(*lead, h)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _layer(layer, config: DeepseekV2Config, hidden, cos, sin, mask_bias, cache, cache_index,
           attention_mask):
    attn_in = _rms_norm(hidden, layer["input_norm"], config.rms_norm_eps)
    hidden = hidden + _attention(layer["attention"], config, attn_in, cos, sin, mask_bias, cache,
                                 cache_index, key_padding_mask=attention_mask)
    mlp_in = _rms_norm(hidden, layer["post_attention_norm"], config.rms_norm_eps)
    if "moe" in layer:
        return hidden + _moe(layer["moe"], config, mlp_in)
    return hidden + _mlp(layer["mlp"], mlp_in)


def deepseek_v2_forward(params: dict, config: DeepseekV2Config,
                        input_ids: Optional[torch.Tensor] = None,
                        inputs_embeds: Optional[torch.Tensor] = None,
                        attention_mask: Optional[torch.Tensor] = None,
                        positions: Optional[torch.Tensor] = None,
                        kv_caches: Optional[list] = None, cache_index=0,
                        logit_caption_len: Optional[int] = None):
    """Returns (logits [B, T, V] f32, kv_caches), with the arguments of
    :func:`~aat_tpu_torch.models.llama.llama_forward` (no packing, no
    mesh): prefill with a [B, T] mask (or [B, L_cache] with ``kv_caches``),
    decode with ``kv_caches`` updated in place, ``cache_index`` (scalar or
    [B]); ``logit_caption_len``: logits of the shifted caption window only."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids)
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    kv_len = t if kv_caches is None else kv_caches[0][0].shape[2]
    if attention_mask is None:
        attention_mask = torch.ones((b, kv_len), dtype=torch.int32, device=dev)
    if positions is None:
        base = torch.arange(t, device=dev)[None, :].expand(b, t)
        if kv_caches is None:
            positions = base
        elif torch.is_tensor(cache_index) and cache_index.ndim == 1:
            positions = base + cache_index.to(dev)[:, None]
        else:
            positions = base + int(cache_index)
    cos, sin = rope_cos_sin(positions, config)
    mask_bias = causal_mask_bias(attention_mask, t, kv_len,
                                 0 if kv_caches is None else cache_index)
    hidden = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        if kv_caches is None:
            hidden = run_remat(_layer, config, layer, config, hidden, cos, sin, mask_bias, None, 0,
                               attention_mask)
        else:
            hidden = _layer(layer, config, hidden, cos, sin, mask_bias, kv_caches[i],
                            cache_index, attention_mask)
    if logit_caption_len is not None:
        if kv_caches is not None:
            raise ValueError("caption slicing is a training-path feature (no KV cache)")
        hidden = hidden[:, t - logit_caption_len : t - 1, :]
    hidden = _rms_norm(hidden, params["final_norm"], config.rms_norm_eps)
    head = (params["embed_tokens"]["embedding"].t() if config.tie_word_embeddings
            else params["lm_head"]["kernel"])
    ct = torch.promote_types(hidden.dtype, head.dtype)
    return torch.matmul(hidden.to(ct), head.to(ct)).float(), kv_caches


def init_kv_caches(config: DeepseekV2Config, batch_size: int, max_len: int,
                   dtype=torch.float32, device=None):
    """Per-layer (k [B, H, L, 192], v [B, H, L, 128]) caches."""
    shape = (batch_size, config.num_attention_heads, max_len)
    return [(torch.zeros(shape + (config.qk_head_dim,), dtype=dtype, device=device),
             torch.zeros(shape + (config.v_head_dim,), dtype=dtype, device=device))
            for _ in range(config.num_hidden_layers)]
