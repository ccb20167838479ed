"""The plain reference of the ASLM: HuBERT / wav2vec2-large, the linear
projection and a Llama-architecture decoder (SmolLM, Qwen1.5), written in
plain PyTorch float32 from the published architectures, with the
train-mode dropout and LayerDrop the training configuration states (the
rules of :mod:`portbench.reference.hashing`). It imports nothing of the
program.

Attention is one autograd function that works through the heads in chunks
and recomputes the probabilities in its backward, so a long utterance fits
on the card; its arithmetic is the textbook softmax attention's.

``Arith`` says how the reference computes: float32 (the reference), or the
control's lower precision: every product's operands rounded to float8
(e4m3, one scale a tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference import hashing as hsh

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class Arith:
    fp8: bool = False  # round every product's operands to float8 e4m3

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.fp8 else x


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, in ``x``'s dtype; the gradient passes straight
    through."""
    with torch.no_grad():
        scale = 448.0 / x.abs().amax().clamp_min(1e-30)
        y = (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (y - x).detach() if x.requires_grad else y


def head_chunk(b: int, t: int, s: int, heads: int, budget: int = 1 << 27) -> int:
    """Heads per chunk so that one chunk's scores hold ``budget`` elements."""
    return max(1, min(heads, budget // max(b * t * s, 1)))


class PlainAttention(torch.autograd.Function):
    """Softmax attention on ``[B, T, H, D]`` queries and ``[B, S, KVH, D]``
    keys and values (GQA: head h reads kv head h // (H / KVH)), keys masked
    by ``key_mask [B, S]``, causal or dense, rows with no allowed key zero,
    and dropout of the probabilities at ``rate`` with the mask of
    ``hashing.attention_keep`` (seed, first global row ``b0``)."""

    @staticmethod
    def _allowed(key_mask, t, s, causal):
        allowed = key_mask[:, None, None, :] > 0
        if causal:
            tri = torch.ones((t, s), dtype=torch.bool, device=key_mask.device).tril()
            allowed = allowed & tri[None, None]
        return allowed

    @staticmethod
    def _probs(q, k, allowed, h0, hc, rep, scale):
        qh = q[:, :, h0:h0 + hc].transpose(1, 2)
        kv_idx = torch.arange(h0, h0 + hc, device=q.device) // rep
        kh = k.index_select(2, kv_idx).transpose(1, 2)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        scores = scores.masked_fill(~allowed, NEG)
        p = torch.softmax(scores, dim=-1)
        return torch.where(allowed.any(-1, keepdim=True), p, torch.zeros((), device=q.device)), \
            qh, kh, kv_idx

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, rate, seed, b0):
        b, t, h, d = q.shape
        s, kvh = k.shape[1], k.shape[2]
        rep, scale = h // kvh, d ** -0.5
        allowed = PlainAttention._allowed(key_mask, t, s, causal)
        out = torch.empty_like(q)
        hc_max = head_chunk(b, t, s, h)
        for h0 in range(0, h, hc_max):
            hc = min(hc_max, h - h0)
            p, _, _, kv_idx = PlainAttention._probs(q, k, allowed, h0, hc, rep, scale)
            if rate > 0.0 and seed is not None:
                keep = hsh.attention_keep(seed, b0, b, h0, hc, h, t, s, rate, q.device)
                p = torch.where(keep, p / (1.0 - rate), torch.zeros((), device=q.device))
            vh = v.index_select(2, kv_idx).transpose(1, 2)
            out[:, :, h0:h0 + hc] = torch.matmul(p, vh).transpose(1, 2)
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.cfg = (causal, rate, seed, b0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask = ctx.saved_tensors
        causal, rate, seed, b0 = ctx.cfg
        b, t, h, d = q.shape
        s, kvh = k.shape[1], k.shape[2]
        rep, scale = h // kvh, d ** -0.5
        allowed = PlainAttention._allowed(key_mask, t, s, causal)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        hc_max = head_chunk(b, t, s, h)
        for h0 in range(0, h, hc_max):
            hc = min(hc_max, h - h0)
            p, qh, kh, kv_idx = PlainAttention._probs(q, k, allowed, h0, hc, rep, scale)
            vh = v.index_select(2, kv_idx).transpose(1, 2)
            doh = dout[:, :, h0:h0 + hc].transpose(1, 2)
            dpd = torch.matmul(doh, vh.transpose(-1, -2))
            pd = p
            if rate > 0.0 and seed is not None:
                keep = hsh.attention_keep(seed, b0, b, h0, hc, h, t, s, rate, q.device)
                zero = torch.zeros((), device=q.device)
                pd = torch.where(keep, p / (1.0 - rate), zero)
                dpd = torch.where(keep, dpd / (1.0 - rate), zero)
            ds = p * (dpd - (dpd * p).sum(-1, keepdim=True))
            dq[:, :, h0:h0 + hc] = (torch.matmul(ds, kh) * scale).transpose(1, 2)
            dk.index_add_(2, kv_idx, (torch.matmul(ds.transpose(-1, -2), qh) * scale)
                          .transpose(1, 2))
            dv.index_add_(2, kv_idx, torch.matmul(pd.transpose(-1, -2), doh).transpose(1, 2))
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, key_mask, causal, rate=0.0, seed=None, b0=0):
    return PlainAttention.apply(q, k, v, key_mask, causal, rate, seed, b0)


def layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def dense(x, p, ar: Arith):
    y = torch.matmul(ar.op(x), ar.op(p["kernel"]))
    return y + p["bias"] if "bias" in p else y


def conv_frames(enc: dict, samples: torch.Tensor) -> torch.Tensor:
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        samples = torch.div(samples - k, s, rounding_mode="floor") + 1
    return samples


# ---------------------------------------------------------------------------
# HuBERT / wav2vec2-large (pre-LN "stable layer norm", conv layers with
# layer norm)
# ---------------------------------------------------------------------------


def hubert(params, enc: dict, wave, sample_mask, seed: Optional[int], ar: Arith, row0: int = 0):
    """``[B, L]`` waveforms → (``[B, T, H]`` frames, ``[B, T]`` frame mask);
    train mode (dropout and LayerDrop) with an int32 ``seed``."""
    eps = enc["layer_norm_eps"]
    h = wave[:, None, :]
    for i, layer in enumerate(params["feature_extractor"]):
        h = F.conv1d(ar.op(h), ar.op(layer["conv"]["kernel"]), layer["conv"].get("bias"),
                     stride=enc["conv_stride"][i])
        h = F.gelu(layer_norm(h.transpose(1, 2), layer["layer_norm"], eps).transpose(1, 2))
    feats = h.transpose(1, 2)
    t = feats.shape[1]
    lens = conv_frames(enc, sample_mask.sum(-1).to(torch.int64))
    frame_mask = torch.arange(t, device=wave.device)[None, :] < lens[:, None]
    fp = params["feature_projection"]
    hidden = dense(layer_norm(feats, fp["layer_norm"], eps), fp["projection"], ar)
    seed_enc = None
    if seed is not None:
        hidden = hsh.dropout(hsh.fold_seed(seed, 0), hidden, enc["feature_projection_dropout"],
                             row0)
        seed_enc = hsh.fold_seed(seed, 1)
    hidden = hidden * frame_mask[..., None].to(hidden.dtype)
    k = enc["num_conv_pos_embeddings"]
    pos = F.conv1d(ar.op(hidden.transpose(1, 2)), ar.op(params["pos_conv"]["kernel"]),
                   params["pos_conv"]["bias"], padding=k // 2,
                   groups=enc["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    hidden = hidden + F.gelu(pos).transpose(1, 2)
    if seed_enc is not None:
        hidden = hsh.dropout(hsh.fold_seed(seed_enc, hsh.HIDDEN_SITE), hidden,
                             enc["hidden_dropout"], row0)
    nh = enc["num_attention_heads"]
    hd = enc["hidden_size"] // nh
    b = hidden.shape[0]
    key_mask = frame_mask.to(torch.int32)
    for idx, layer in enumerate(params["layers"]):
        s_attn = s_res = s_ff = None
        if seed_enc is not None:
            s_layer = hsh.fold_seed(seed_enc, idx)
            if (enc["layerdrop"] > 0.0 and hsh.uniform_from_seed(
                    hsh.fold_seed(s_layer, hsh.LAYERDROP_SITE)) < enc["layerdrop"]):
                continue
            s_attn, s_res, s_ff = (hsh.fold_seed(s_layer, i) for i in range(3))
        a = layer_norm(hidden, layer["layer_norm"], eps)
        att = layer["attention"]
        q, kk, v = (ar.op(dense(a, att[n], ar)).reshape(b, t, nh, hd) for n in ("q", "k", "v"))
        ctx = attention(q, kk, v, key_mask, False, enc["attention_dropout"], s_attn, row0)
        hidden = hidden + hsh.dropout(s_res, dense(ctx.reshape(b, t, nh * hd), att["out"], ar),
                                      enc["hidden_dropout"], row0)
        ff = layer["feed_forward"]
        y = F.gelu(dense(layer_norm(hidden, layer["final_layer_norm"], eps), ff["intermediate"],
                         ar))
        y = hsh.dropout(None if s_ff is None else hsh.fold_seed(s_ff, 0), y,
                        enc["activation_dropout"], row0)
        y = hsh.dropout(None if s_ff is None else hsh.fold_seed(s_ff, 1),
                        dense(y, ff["output"], ar), enc["hidden_dropout"], row0)
        hidden = hidden + y
    return layer_norm(hidden, params["encoder_layer_norm"], eps), frame_mask


def project(adapter, frames, frame_mask, ar: Arith):
    """The linear projection (k = 1): masked frames → MLP → LM width."""
    x = frames * frame_mask[..., None].to(frames.dtype)
    return dense(F.relu(dense(x, adapter["projection"]["in"], ar)), adapter["projection"]["out"],
                 ar)


def assemble(adapter, projected, proj_mask, text_embeds, text_mask):
    """``[aBOS | audio | aEOS | text]`` embeddings and their mask."""
    b = projected.shape[0]
    emb = adapter["audio_tokens_embeddings"]["embedding"]
    bos = emb[0][None, None, :].expand(b, 1, -1)
    eos = emb[1][None, None, :].expand(b, 1, -1)
    ones = torch.ones((b, 1), dtype=torch.int32, device=projected.device)
    pieces, masks = [bos, projected, eos], [ones, proj_mask.to(torch.int32), ones]
    if text_embeds is not None:
        pieces.append(text_embeds)
        masks.append(text_mask.to(torch.int32))
    return torch.cat(pieces, 1), torch.cat(masks, 1)


# ---------------------------------------------------------------------------
# Llama architecture (RMSNorm, RoPE in the half-split layout, GQA, SwiGLU)
# ---------------------------------------------------------------------------


def rms_norm(x, p, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


def rope(x, positions, theta):
    """``x [B, T, H, D]`` rotated at ``positions [B, T]``."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, :, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def llama(params, lm: dict, embeds, mask, positions, ar: Arith, head_from: int = 0):
    """Causal decoder over ``embeds [B, T, H]`` with key mask ``mask [B, T]``
    → f32 logits of positions ``head_from ...``."""
    b, t, _ = embeds.shape
    nh, nkv = lm["num_attention_heads"], lm["num_key_value_heads"]
    hd = lm["hidden_size"] // nh
    eps = lm["rms_norm_eps"]
    hidden = embeds
    for layer in params["layers"]:
        att = layer["attention"]
        a = rms_norm(hidden, layer["input_norm"], eps)
        q = rope(dense(a, att["q"], ar).reshape(b, t, nh, hd), positions, lm["rope_theta"])
        k = rope(dense(a, att["k"], ar).reshape(b, t, nkv, hd), positions, lm["rope_theta"])
        v = dense(a, att["v"], ar).reshape(b, t, nkv, hd)
        ctx = attention(ar.op(q), ar.op(k), ar.op(v), mask, True)
        hidden = hidden + dense(ctx.reshape(b, t, nh * hd), att["out"], ar)
        mlp = layer["mlp"]
        m = rms_norm(hidden, layer["post_attention_norm"], eps)
        hidden = hidden + dense(F.silu(dense(m, mlp["gate"], ar)) * dense(m, mlp["up"], ar),
                                mlp["down"], ar)
    hidden = rms_norm(hidden[:, head_from:], params["final_norm"], eps)
    head = (params["embed_tokens"]["embedding"].t() if lm["tie_word_embeddings"]
            else params["lm_head"]["kernel"])
    return torch.matmul(ar.op(hidden), ar.op(head))
