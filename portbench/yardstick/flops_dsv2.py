"""Model FLOPs of the HuBERT → DeepSeek-V2 ASLM, the benchmark's count
(``flops``' conventions: valid lengths only, causal attention at half,
recompute not counted; the encoder and adapter trained, 3x their forward;
the LM frozen above them, 2x its forward: its input-gradient products
only). The LM's expert layers count this chip's share: the held experts'
products on their part of the routed pairs (``seq · top-k · held /
experts``, routing taken as even), the router and the shared experts on
every token."""

from __future__ import annotations

from portbench.yardstick import flops


def deepseek_v2_row_flops(cfg: dict, seq: int, head_positions: int) -> float:
    """One decoder forward over one row of ``seq`` valid tokens, causal,
    and the head over ``head_positions`` of them (``cfg``: the configuration
    file, the published keys at its top level)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                            cfg["v_head_dim"], cfg["kv_lora_rank"])
    attn = 2.0 * seq * (h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + dv)
                        + nh * dv * h)
    attn += 2.0 * seq * seq * nh * (nope + rope + dv) / 2  # causal: half the dense scores, p·v
    w = cfg["moe_intermediate_size"]
    pairs = seq * cfg["num_experts_per_tok"] * cfg["experts_held"] / cfg["n_routed_experts"]
    moe = (2.0 * seq * h * cfg["n_routed_experts"]
           + 3 * 2.0 * h * w * (seq * cfg["n_shared_experts"] + pairs))
    dense = 3 * 2.0 * seq * h * cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    n_moe = sum(1 for i in range(layers)
                if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0)
    return (layers * attn + n_moe * moe + (layers - n_moe) * dense
            + 2.0 * head_positions * h * cfg["vocab_size"])


def train_row_flops(config: dict, samples: int, text_tokens: int) -> float:
    """``flops.train_row_flops`` with the DeepSeek-V2 decoder."""
    enc = config["hubert"]
    frames = flops.conv_frames(enc["conv_kernel"], enc["conv_stride"], samples)
    proj = flops.projection_row_flops(enc["hidden_size"], config["projection_hidden"],
                                      config["hidden_size"], frames)
    seq = frames + 2 + text_tokens  # [aBOS | audio | aEOS | text]
    lm_fwd = deepseek_v2_row_flops(config, seq, max(text_tokens - 1, 0))
    return 3.0 * flops.hubert_row_flops(enc, samples) + 3.0 * proj + 2.0 * lm_fwd
