"""Analytic model-FLOPs accounting for MFU reporting (a copy of
``aat_tpu/utils/flops.py``; the peak is the H100's).

Standard matmul-only convention (the one MFU is defined against): a matmul
[m, k] @ [k, n] is 2·m·k·n flops; elementwise/norm/softmax work is ignored;
rematerialized recompute is NOT counted (MFU measures model flops, not
hardware flops). Backward multipliers per submodule:

- trainable submodule: forward + weight-grad + input-grad = 3× forward
- frozen submodule ABOVE a trainable one (the LM decoder over the trainable
  adapter): forward + input-grad chain = 2× forward
- frozen submodule with nothing trainable BELOW it (the audio encoder when
  train_audio_encoder=False): forward only = 1× (its input needs no
  gradient, so no backward runs through it)

The flagship step: hubert-large encoder + SmolLM-135M decoder, caption CE
loss.
"""

from __future__ import annotations

from typing import Optional


def conv_extractor_frames(cfg, frames: int) -> int:
    """Output frame count of the HuBERT conv feature extractor."""
    t = frames
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // s + 1
    return t


def hubert_forward_flops(cfg, n_rows: int, frames: int) -> float:
    """One HuBERT forward over [n_rows, frames] waveform samples."""
    # conv feature extractor: conv i maps T_i -> T_{i+1} frames with
    # [k·c_in, c_out] matmuls per output frame
    total = 0.0
    t = frames
    c_in = 1
    for c_out, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t_out = (t - k) // s + 1
        total += 2.0 * n_rows * t_out * k * c_in * c_out
        t, c_in = t_out, c_out
    # feature projection conv_dim[-1] -> hidden
    total += 2.0 * n_rows * t * cfg.conv_dim[-1] * cfg.hidden_size
    # positional conv embedding (grouped conv, kernel num_conv_pos_embeddings)
    total += 2.0 * n_rows * t * cfg.num_conv_pos_embeddings * (
        cfg.hidden_size * cfg.hidden_size // cfg.num_conv_pos_embedding_groups
    )
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_layer = (
        4 * 2.0 * t * h * h          # q, k, v, o projections
        + 2 * 2.0 * t * t * h        # scores + probs·V
        + 2 * 2.0 * t * h * i        # FFN in + out
    )
    total += n_rows * cfg.num_hidden_layers * per_layer
    return total


def llama_forward_flops(cfg, n_rows: int, seq: int,
                        with_lm_head: bool = True) -> float:
    """One Llama-family decoder forward over [n_rows, seq] embeddings."""
    h = cfg.hidden_size
    kv_h = h * cfg.num_key_value_heads // cfg.num_attention_heads
    per_layer = (
        2.0 * seq * h * h            # q
        + 2 * 2.0 * seq * h * kv_h   # k, v (GQA)
        + 2.0 * seq * h * h          # o
        + 2 * 2.0 * seq * seq * h    # scores + probs·V (causal: the MFU
                                     # convention counts the dense cost)
        + 3 * 2.0 * seq * h * cfg.intermediate_size  # gate, up, down
    )
    total = n_rows * cfg.num_hidden_layers * per_layer
    if with_lm_head:
        total += 2.0 * n_rows * seq * h * cfg.vocab_size
    return total


def deepseek_v2_forward_flops(cfg, n_rows: int, seq: int, with_lm_head: bool = True) -> float:
    """One DeepSeek-V2 decoder forward over [n_rows, seq] embeddings: MLA's
    five projections and its scores (q·k 192 wide, p·v 128, the dense cost),
    the dense layers' SwiGLU, and in each expert layer the router, the
    shared experts and the held experts' share of the routed pairs
    (``seq · top-k · held / experts``, routing taken as even)."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    dqk, dv, rank = cfg.qk_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    attn = 2.0 * seq * (h * nh * dqk + h * (rank + cfg.qk_rope_head_dim)
                        + rank * nh * (cfg.qk_nope_head_dim + dv) + nh * dv * h)
    attn += 2.0 * seq * seq * nh * (dqk + dv)
    w = cfg.moe_intermediate_size
    pairs = seq * cfg.num_experts_per_tok * cfg.experts_held / cfg.n_routed_experts
    moe = 2.0 * seq * h * cfg.n_routed_experts + 3 * 2.0 * h * w * (
        seq * cfg.n_shared_experts + pairs)
    dense = 3 * 2.0 * seq * h * cfg.intermediate_size
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers))
    total = n_rows * (cfg.num_hidden_layers * attn + n_moe * moe
                      + (cfg.num_hidden_layers - n_moe) * dense)
    if with_lm_head:
        total += 2.0 * n_rows * seq * h * cfg.vocab_size
    return total


def projection_flops(aslm_cfg, n_rows: int, frames_per_row: int) -> float:
    """Adapter projection forward (linear path: reshape-MLP;
    transformer_encoder path: the 4-layer pooling encoder)."""
    e = aslm_cfg.audio_encoder_hidden
    if aslm_cfg.projection_type == "linear":
        k = aslm_cfg.audio_encoder_embeddings_seq_len
        groups = frames_per_row // k
        return 2.0 * n_rows * groups * (
            e * k * aslm_cfg.projection_hidden
            + aslm_cfg.projection_hidden * aslm_cfg.lm_hidden
        )
    if aslm_cfg.projection_type == "mean":
        return 2.0 * n_rows * e * aslm_cfg.lm_hidden
    p = aslm_cfg.pooling
    t = frames_per_row + 1  # CLS token
    per_layer = (
        4 * 2.0 * t * p.hidden_dim * p.hidden_dim
        + 2 * 2.0 * t * t * p.hidden_dim
        + 2 * 2.0 * t * p.hidden_dim * p.ffn_dim
    )
    return n_rows * (
        2.0 * t * e * p.hidden_dim           # l_in
        + p.num_layers * per_layer
        + 2.0 * p.hidden_dim * aslm_cfg.lm_hidden  # l_out on CLS
    )


def aslm_train_step_flops(
    enc_cfg,
    lm_cfg,
    aslm_cfg,
    batch_size: int,
    n_segments: Optional[int],
    segment_frames: int,
    text_len: int,
    train_audio_encoder: bool = True,
    train_lm_decoder: bool = False,
) -> dict:
    """Model FLOPs of ONE optimizer step (accum=1) of the ASLM trainer.

    ``n_segments=None`` = whole-utterance path ([B, segment_frames] straight
    through the encoder). Returns component and total counts."""
    rows = batch_size * n_segments if n_segments else batch_size
    enc_fwd = hubert_forward_flops(enc_cfg, rows, segment_frames)
    enc_frames = conv_extractor_frames(enc_cfg, segment_frames)
    proj_fwd = projection_flops(aslm_cfg, rows, enc_frames)
    if n_segments:
        audio_tokens = n_segments  # one token per segment after pooling
        if aslm_cfg.projection_type == "linear":
            audio_tokens = n_segments * (
                enc_frames // aslm_cfg.audio_encoder_embeddings_seq_len)
    else:
        audio_tokens = enc_frames // max(
            1, aslm_cfg.audio_encoder_embeddings_seq_len)
    lm_seq = audio_tokens + 2 + text_len  # [aBOS | audio | aEOS | text]
    from aat_tpu_torch.models import decoders

    lm_fwd = (deepseek_v2_forward_flops if decoders.decoder_type(lm_cfg) == decoders.DEEPSEEK_V2
              else llama_forward_flops)(lm_cfg, batch_size, lm_seq)

    enc_mult = 3.0 if train_audio_encoder else 1.0
    proj_mult = 3.0  # the adapter always trains
    # decoder sits ABOVE the adapter: its input-grad chain always runs
    lm_mult = 3.0 if train_lm_decoder else 2.0
    total = enc_mult * enc_fwd + proj_mult * proj_fwd + lm_mult * lm_fwd
    return {
        "encoder_fwd": enc_fwd,
        "projection_fwd": proj_fwd,
        "lm_fwd": lm_fwd,
        "lm_seq": lm_seq,
        "total": total,
    }


# dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, 700 W)
H100_BF16_PEAK = 989e12


def mfu(total_flops: float, step_seconds: float,
        peak: float = H100_BF16_PEAK) -> float:
    """Model FLOPs over step time over ``peak``."""
    return total_flops / step_seconds / peak
