"""Model FLOPs of the ASLM, the benchmark's own count (a frozen copy of the
port's ``utils/flops.py``, corrected in two ways that file's docstring
states it does not make):

- rows count their valid lengths only: a padded sample, frame or token is
  no model work, however much the program computes on it;
- causal attention costs half the dense scores and probs·V.

Matmul convention: ``[m, k] @ [k, n]`` is ``2·m·k·n``; element-wise, norm
and softmax work is not counted; recompute (remat) is not model work.
Backward multipliers: a trained submodule 3x its forward, a frozen one
above a trained one (the LM over the adapter) 2x, the adapter 3x.
"""

from __future__ import annotations

from typing import Sequence


def conv_frames(conv_kernel: Sequence[int], conv_stride: Sequence[int], samples: int) -> int:
    """HuBERT's conv feature extractor's output frames for ``samples``."""
    t = samples
    for k, s in zip(conv_kernel, conv_stride):
        t = (t - k) // s + 1
    return max(t, 0)


def hubert_row_flops(enc: dict, samples: int) -> float:
    """One HuBERT forward over one row of ``samples`` valid samples
    (``enc``: the configuration's ``hubert`` group)."""
    total, t, c_in = 0.0, samples, 1
    for c_out, k, s in zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"]):
        t = (t - k) // s + 1
        if t <= 0:
            return total
        total += 2.0 * t * k * c_in * c_out
        c_in = c_out
    h, i = enc["hidden_size"], enc["intermediate_size"]
    total += 2.0 * t * enc["conv_dim"][-1] * h  # feature projection
    total += 2.0 * t * enc["num_conv_pos_embeddings"] * h * h / enc["num_conv_pos_embedding_groups"]
    per_layer = 4 * 2.0 * t * h * h + 2 * 2.0 * t * t * h + 2 * 2.0 * t * h * i
    return total + enc["num_hidden_layers"] * per_layer


def llama_row_flops(lm: dict, seq: int, head_positions: int) -> float:
    """One decoder forward over one row of ``seq`` valid tokens, causal, and
    the vocabulary head over ``head_positions`` of them (``lm``: the
    configuration's ``lm`` group)."""
    h = lm["hidden_size"]
    kv = h * lm["num_key_value_heads"] // lm["num_attention_heads"]
    per_layer = (2.0 * seq * h * h + 2 * 2.0 * seq * h * kv + 2.0 * seq * h * h
                 + 2 * 2.0 * seq * seq * h / 2  # causal: half the dense scores and probs·V
                 + 3 * 2.0 * seq * h * lm["intermediate_size"])
    return lm["num_hidden_layers"] * per_layer + 2.0 * head_positions * h * lm["vocab_size"]


def projection_row_flops(encoder_hidden: int, projection_hidden: int, lm_hidden: int,
                         frames: int) -> float:
    """The linear projection (k = 1) over ``frames`` valid frames."""
    return 2.0 * frames * (encoder_hidden * projection_hidden + projection_hidden * lm_hidden)


def train_row_flops(config: dict, samples: int, text_tokens: int) -> float:
    """Model FLOPs of one whole-utterance training row: ``samples`` valid
    audio samples and ``text_tokens`` valid caption tokens, encoder and
    adapter trained, LM frozen (its input-gradient chain runs)."""
    enc, lm = config["hubert"], config["lm"]
    frames = conv_frames(enc["conv_kernel"], enc["conv_stride"], samples)
    proj = projection_row_flops(enc["hidden_size"], config["projection_hidden"],
                                lm["hidden_size"], frames)
    seq = frames + 2 + text_tokens  # [aBOS | audio | aEOS | text]
    lm_fwd = llama_row_flops(lm, seq, max(text_tokens - 1, 0))
    return 3.0 * hubert_row_flops(enc, samples) + 3.0 * proj + 2.0 * lm_fwd

