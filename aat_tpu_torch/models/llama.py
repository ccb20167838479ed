"""Llama-family causal LM decoder (counterpart of ``aat_tpu/models/llama.py``).

RoPE in float32 (HF half-split layout), GQA, a static-shape KV cache
updated in place, f32-accumulated dense products. Parameters are plain
dictionaries of tensors in the JAX package's tree layout (dense kernels
``[in, out]``).

Where the JAX code mixes dtypes (a bf16 KV cache under f32 activations),
JAX promotes to f32; ``torch.matmul`` refuses mixed operands, so the port
casts explicitly to the promoted type at those points.

Routes of attention: the KV cache (serving prefill and decode), the
plain no-cache route, and the causal flash route that a no-cache
``attention_impl="pallas"`` call takes at T >= 256 (training and the
eval-loss forward). Also ported: sequence packing (``pack_len``),
caption-sliced logits (``logit_caption_len``), remat of the no-cache
route (``LlamaConfig.remat`` / ``remat_policy``, HuBERT's ``"full"`` and
``"dots"`` machinery) and, given the trainer's mesh
(``llama_forward(mesh=...)``), tensor parallelism where
:func:`tp_partitionable` holds: each layer a Megatron body on this rank's
heads, kv heads and MLP columns, the out and down products all-reduced;
and under the mesh's pp axis the no-cache route pipelined
(:func:`~aat_tpu_torch.parallel.pipeline.gpipe_apply` over this stage's
stacked layers; the per-row rotary tables, mask bias and key mask follow
the microbatch split; tp bodies inside where :func:`tp_partitionable`
holds). The KV-cache route runs a stacked tree's layers as a plain loop
(JAX's ``layer_seq``): generation gathers the whole LM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from aat_tpu_torch.models.hubert import np_rng_from, run_remat
from aat_tpu_torch.ops import attention as attn_ops
from aat_tpu_torch.parallel import comm
from aat_tpu_torch.parallel.pipeline import gpipe_apply, layer_seq
from aat_tpu_torch.utils.port import to_tensors


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 49152
    hidden_size: int = 576
    intermediate_size: int = 1536
    num_hidden_layers: int = 30
    num_attention_heads: int = 9
    num_key_value_heads: int = 3
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    attention_impl: str = "xla"  # 'xla' | 'pallas' (causal flash kernel)
    remat: bool = False  # recompute decoder layers in the backward (no-cache route)
    remat_policy: str = "full"  # 'full' | 'dots' (see HubertConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tp_partitionable(config: LlamaConfig, tp: int) -> bool:
    """True when heads, kv heads and the MLP hidden all split evenly over
    ``tp`` (the gate of the tensor-parallel body, JAX's predicate)."""
    return (tp > 1 and config.num_attention_heads % tp == 0
            and config.num_key_value_heads % tp == 0
            and config.intermediate_size % tp == 0)


def _tp_group(config: LlamaConfig, mesh):
    """The tp group when the layers run as tensor-parallel bodies, else None."""
    if mesh is None or not tp_partitionable(config, mesh.size("tp")):
        return None
    return mesh.group("tp")


def smollm_135m_config() -> LlamaConfig:
    """HuggingFaceTB/SmolLM-135M-Instruct."""
    return LlamaConfig(attention_impl="pallas")


def qwen15_18b_config() -> LlamaConfig:
    """Qwen/Qwen1.5-1.8B through the Llama architecture: 24 layers, width
    2048, 16/16 heads (D = 128), attention biases, untied head, θ = 1e6,
    32768 positions."""
    return LlamaConfig(vocab_size=151936, hidden_size=2048, intermediate_size=5504,
                       num_hidden_layers=24, num_attention_heads=16,
                       num_key_value_heads=16, rope_theta=1000000.0,
                       max_position_embeddings=32768, tie_word_embeddings=False,
                       attention_bias=True, attention_impl="pallas")


def tiny_test_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128,
                       tie_word_embeddings=False)


def init_llama_numpy(seed, config: LlamaConfig, std: float = 0.02) -> dict:
    """The JAX package's draws, as numpy: ``seed`` is an int or a JAX PRNG
    key's data words (:func:`~aat_tpu_torch.models.hubert.np_rng_from`)."""
    r = np_rng_from(seed)
    h, kvh = config.hidden_size, config.num_key_value_heads * config.head_dim

    def dense(din, dout, bias):
        p = {"kernel": r.normal(0.0, std, (din, dout)).astype(np.float32)}
        if bias:
            p["bias"] = np.zeros((dout,), np.float32)
        return p

    params = {
        "embed_tokens": {"embedding": r.normal(0.0, std, (config.vocab_size, h)).astype(np.float32)},
        "layers": [],
        "final_norm": {"scale": np.ones((h,), np.float32)},
    }
    for _ in range(config.num_hidden_layers):
        params["layers"].append({
            "input_norm": {"scale": np.ones((h,), np.float32)},
            "attention": {
                "q": dense(h, h, config.attention_bias),
                "k": dense(h, kvh, config.attention_bias),
                "v": dense(h, kvh, config.attention_bias),
                "out": dense(h, h, False),
            },
            "post_attention_norm": {"scale": np.ones((h,), np.float32)},
            "mlp": {
                "gate": dense(h, config.intermediate_size, False),
                "up": dense(h, config.intermediate_size, False),
                "down": dense(config.intermediate_size, h, False),
            },
        })
    if not config.tie_word_embeddings:
        params["lm_head"] = dense(h, config.vocab_size, False)
    return params


def init_llama_params(seed, config: LlamaConfig, device=None) -> dict:
    """Random init equal to the JAX package's ``init_llama_params`` of the
    same int seed or PRNG key."""
    return to_tensors(init_llama_numpy(seed, config), device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _rms_norm(x, p, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    # bf16 x: the rounded result times the f32 scale promotes back to f32,
    # as in JAX
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def _dense(x, p, tp_group=None):
    """JAX ``einsum(x, kernel, preferred_element_type=f32).astype(x.dtype)``:
    mixed operands compute in the promoted type. With ``tp_group`` the
    kernel's input rows are this rank's shard: the partial products are
    all-reduced before the bias."""
    ct = torch.promote_types(x.dtype, p["kernel"].dtype)
    y = comm.reduce_from_group(torch.matmul(x.to(ct), p["kernel"].to(ct)).to(x.dtype), tp_group)
    if "bias" in p:
        y = y + p["bias"]
    return y


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, T] → cos/sin [B, T, head_dim], float32, HF layout."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions[..., None].float() * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(q, k, cos, sin):
    # q/k: [B, H, T, D]; cos/sin: [B, T, D]
    cos, sin = cos[:, None], sin[:, None]
    q32, k32 = q.float(), k.float()
    q_out = q32 * cos + _rotate_half(q32) * sin
    k_out = k32 * cos + _rotate_half(k32) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _attention(p, config: LlamaConfig, x, cos, sin, mask_bias, kv_cache, cache_index,
               key_padding_mask=None, pack_len=None, mesh=None):
    b, t, h = x.shape
    if (pack_len is not None and kv_cache is None
            and key_padding_mask is not None and t != pack_len):
        # packing is exactly block-diagonal: unfold the K packed utterances
        # into the batch and run plain causal attention at T = pack_len (the
        # JAX package's route; kernel-level pack_len stays for its API)
        kq = t // pack_len
        am = key_padding_mask.reshape(b * kq, pack_len)
        out = _attention(p, config, x.reshape(b * kq, pack_len, h),
                         cos.reshape(b * kq, pack_len, cos.shape[-1]),
                         sin.reshape(b * kq, pack_len, sin.shape[-1]),
                         causal_mask_bias(am, pack_len, pack_len, 0), None, 0,
                         key_padding_mask=am, mesh=mesh)
        return out.reshape(b, t, out.shape[-1])
    hd = config.head_dim
    tp_group = _tp_group(config, mesh)
    if tp_group is not None and kv_cache is not None:
        raise ValueError("the tensor-parallel body is a training-path route (no KV cache)")
    x = comm.copy_to_group(x, tp_group)
    nh = p["q"]["kernel"].shape[-1] // hd  # this rank's heads under tp
    nkv = p["k"]["kernel"].shape[-1] // hd
    q = _dense(x, p["q"]).reshape(b, t, nh, hd).transpose(1, 2)
    k = _dense(x, p["k"]).reshape(b, t, nkv, hd).transpose(1, 2)
    v = _dense(x, p["v"]).reshape(b, t, nkv, hd).transpose(1, 2)
    q, k = _apply_rope(q, k, cos, sin)

    if kv_cache is not None:
        # the cache tensors are updated in place (JAX returns new arrays
        # and donates the old ones to the same effect)
        ck, cv = kv_cache  # [B, nkv, L_cache, D]
        if torch.is_tensor(cache_index) and cache_index.ndim == 1:
            # per-row write offsets (continuous batching); single-token steps
            if t != 1:
                raise ValueError("vector cache_index requires single-token decode")
            bidx = torch.arange(b, device=x.device)
            ci = cache_index.to(device=x.device, dtype=torch.int64)
            ck[bidx, :, ci, :] = k[:, :, 0, :].to(ck.dtype)
            cv[bidx, :, ci, :] = v[:, :, 0, :].to(cv.dtype)
        else:
            i0 = int(cache_index)
            ck[:, :, i0 : i0 + t, :] = k.to(ck.dtype)
            cv[:, :, i0 : i0 + t, :] = v.to(cv.dtype)
        k, v = ck, cv
    elif (config.attention_impl == "pallas" and key_padding_mask is not None
          and t >= attn_ops.MIN_PALLAS_SEQ_LEN):
        # causal flash route for training / eval-loss prefill (q_len ==
        # kv_len, offset 0); GQA k/v go in unrepeated, the kernels map heads
        ctx = attn_ops.flash_attention(q, k, v, key_padding_mask, True, hd ** -0.5,
                                       pack_len=pack_len)
        return _dense(ctx.transpose(1, 2).reshape(b, t, nh * hd), p["out"], tp_group)

    if nkv != nh:
        rep = nh // nkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)

    ct = torch.promote_types(q.dtype, k.dtype)
    scores = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)).float() * (hd ** -0.5)
    scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    ctx = torch.matmul(probs.to(ct), v.to(ct)).to(x.dtype)
    ctx = ctx.transpose(1, 2).reshape(b, t, nh * hd)
    return _dense(ctx, p["out"], tp_group)


def _mlp(p, x, config: LlamaConfig, mesh=None):
    tp_group = _tp_group(config, mesh)
    x = comm.copy_to_group(x, tp_group)
    return _dense(F.silu(_dense(x, p["gate"])) * _dense(x, p["up"]), p["down"], tp_group)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"]["embedding"][input_ids]


def causal_mask_bias(attention_mask: torch.Tensor, q_len: int, kv_len: int,
                     q_offset, pack_len: Optional[int] = None) -> torch.Tensor:
    """Additive [B, 1, Q, K] bias: causality plus key padding. ``q_offset``
    is a scalar or a per-row [B] vector (continuous batching). ``pack_len``:
    attention also stays within each packed utterance (offset 0)."""
    dev = attention_mask.device
    neg = torch.finfo(torch.float32).min
    k_pos = torch.arange(kv_len, device=dev)[None, :]
    if torch.is_tensor(q_offset) and q_offset.ndim == 1:
        q_pos = (torch.arange(q_len, device=dev)[None, :, None]
                 + q_offset.to(device=dev, dtype=torch.int64)[:, None, None])
        causal = k_pos[None] <= q_pos  # [B, Q, K]
    else:
        q_pos = torch.arange(q_len, device=dev)[:, None] + int(q_offset)
        causal = (k_pos <= q_pos)[None]  # [1, Q, K]
    if pack_len is not None:
        causal = causal & (q_pos // pack_len == k_pos // pack_len)
    allowed = causal & (attention_mask[:, None, :] > 0)
    return torch.where(allowed, 0.0, neg).to(torch.float32)[:, None, :, :]


def _layer(layer, config: LlamaConfig, hidden, cos, sin, mask_bias, cache, cache_index,
           attention_mask, pack_len, mesh):
    """One decoder layer: pre-norm attention, then the pre-norm MLP."""
    attn_in = _rms_norm(hidden, layer["input_norm"], config.rms_norm_eps)
    hidden = hidden + _attention(layer["attention"], config, attn_in, cos, sin, mask_bias, cache,
                                 cache_index, key_padding_mask=attention_mask,
                                 pack_len=pack_len, mesh=mesh)
    mlp_in = _rms_norm(hidden, layer["post_attention_norm"], config.rms_norm_eps)
    return hidden + _mlp(layer["mlp"], mlp_in, config, mesh)


def _run_layer(layer, config: LlamaConfig, hidden, cos, sin, mask_bias, attention_mask,
               pack_len, mesh):
    """One layer of the no-cache route, checkpointed when ``config.remat``
    (HuBERT's :func:`~aat_tpu_torch.models.hubert.run_remat`)."""
    return run_remat(_layer, config, layer, config, hidden, cos, sin, mask_bias, None, 0,
                     attention_mask, pack_len, mesh)


def llama_forward(params: dict, config: LlamaConfig,
                  input_ids: Optional[torch.Tensor] = None,
                  inputs_embeds: Optional[torch.Tensor] = None,
                  attention_mask: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  kv_caches: Optional[list] = None,
                  cache_index=0,
                  pack_len: Optional[int] = None,
                  logit_caption_len: Optional[int] = None, mesh=None,
                  microbatches: int = 0):
    """Returns (logits [B, T, V] f32, kv_caches).

    Prefill: embeds/ids and a [B, T] mask (or a [B, L_cache] mask with
    ``kv_caches``). Decode: next-token embeds, ``kv_caches`` (updated in
    place and returned), ``cache_index`` (scalar or [B]) and a
    [B, L_cache] mask over the cache axis. ``pack_len``: rows are packed
    equal-length utterances (block-diagonal attention; pass per-utterance
    ``positions``). ``logit_caption_len``: logits only for the shifted
    caption window, ``[B, K·(cl−1), V]`` with K packed utterances per row;
    the hidden state is sliced before the final norm and the vocab GEMM.
    ``mesh`` (the trainer's, or None) selects the tensor-parallel bodies
    and, without ``kv_caches``, the pipeline (in ``microbatches``, 0:
    2·pp)."""
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

    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta)
    mask_bias = causal_mask_bias(attention_mask, t, kv_len,
                                 0 if kv_caches is None else cache_index, pack_len)

    hidden = inputs_embeds
    n = config.num_hidden_layers
    if kv_caches is None and mesh is not None and mesh.size("pp") > 1:
        # the per-row tables follow the microbatch split
        cos, sin = (x.expand(b, *x.shape[1:]) for x in (cos, sin))
        mask_bias = mask_bias.expand(b, *mask_bias.shape[1:])

        def layer_fn(h, layer, idx, shard, cos_mb, sin_mb, bias_mb, mask_mb):
            return _run_layer(layer, config, h, cos_mb, sin_mb, bias_mb, mask_mb, pack_len, mesh)

        hidden = gpipe_apply(layer_fn, params["layers"], hidden,
                             (cos, sin, mask_bias, attention_mask), mesh, num_layers=n,
                             microbatches=microbatches)
    elif kv_caches is None:
        for layer in layer_seq(params["layers"], n)[:n]:
            hidden = _run_layer(layer, config, hidden, cos, sin, mask_bias, attention_mask,
                                pack_len, mesh)
    else:
        for i, layer in enumerate(layer_seq(params["layers"], n)[:n]):
            hidden = _layer(layer, config, hidden, cos, sin, mask_bias, kv_caches[i],
                            cache_index, attention_mask, pack_len, mesh)

    if logit_caption_len is not None:
        if kv_caches is not None:
            raise ValueError("caption slicing is a training-path feature (no KV cache)")
        cl, p = logit_caption_len, pack_len or t
        hidden = hidden.reshape(b, t // p, p, hidden.shape[-1])[:, :, p - cl : p - 1, :]
        hidden = hidden.reshape(b, (t // p) * (cl - 1), hidden.shape[-1])
    hidden = _rms_norm(hidden, params["final_norm"], config.rms_norm_eps)
    head = (params["embed_tokens"]["embedding"].t() if config.tie_word_embeddings
            else params["lm_head"]["kernel"])
    ct = torch.promote_types(hidden.dtype, head.dtype)
    logits = torch.matmul(hidden.to(ct), head.to(ct)).float()
    return logits, kv_caches


def init_kv_caches(config: LlamaConfig, batch_size: int, max_len: int,
                   dtype=torch.float32, device=None):
    """Static-shape per-layer (k, v) caches ``[B, nkv, max_len, D]``."""
    shape = (batch_size, config.num_key_value_heads, max_len, config.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.num_hidden_layers)]
