"""The benchmark's yardsticks against counts worked out by hand."""

import pytest
import torch

from portbench.yardstick import bounds, flops, peaks, trace

ENC = {"conv_dim": [4], "conv_kernel": [2], "conv_stride": [2], "hidden_size": 8,
       "num_hidden_layers": 1, "intermediate_size": 16, "num_conv_pos_embeddings": 2,
       "num_conv_pos_embedding_groups": 2}
LM = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
      "intermediate_size": 8, "num_hidden_layers": 1, "vocab_size": 10}
CONFIG = {"hubert": ENC, "lm": LM, "projection_hidden": 6}


@pytest.mark.parametrize("samples, text, want", [
    # 10 samples → 5 frames: encoder 80 + 320 + 640 + 5,920 = 6,960; projection
    # 720; LM over 10 tokens 3,680 + head over 2 positions 160 = 3,840;
    # 3 x 6,960 + 3 x 720 + 2 x 3,840
    (10, 3, 30720.0),
    # 6 samples → 3 frames: encoder 3,984; projection 432; LM over 6 tokens
    # 2,016, no head position; 3 x 3,984 + 3 x 432 + 2 x 2,016
    (6, 1, 17280.0),
])
def test_train_row_flops_by_hand(samples, text, want):
    assert flops.train_row_flops(CONFIG, samples, text) == want


def test_attention_bound_bytes_by_hand():
    mask = torch.tensor([[1, 1, 1, 0], [1, 0, 1, 0]])
    # valid queries only: 3 x 3 + 2 x 2 dense; causal, query i sees the
    # valid keys at or before it: 1 + 2 + 3 and 1 + 2
    assert float(bounds.allowed_pairs(mask, False)) == 13
    assert float(bounds.allowed_pairs(mask, True)) == 9
    # bf16 forward [1, 4, 2, 64], kv 1 head: q and out 1,024 B each, k and v
    # 512 B each, mask 16 B, lse 32 B; the 18 pairs' operations are far less
    got = bounds.attention_seconds("fwd", "bfloat16", 1, 4, 2, 1, 64, 9, 0.0)
    assert got == pytest.approx(3120 / peaks.HBM_BYTES_PER_S, rel=1e-12)
    # the fused backward: q, out, dout, dq 1,024 B each, k, v, dk, dv 512 B
    # each, mask 16 B, lse 32 B
    got = bounds.attention_seconds("bwd", "bfloat16", 1, 4, 2, 1, 64, 9, 0.0)
    assert got == pytest.approx(6192 / peaks.HBM_BYTES_PER_S, rel=1e-12)


def test_attention_bound_operations_by_hand():
    t, h, d = 4096, 16, 128
    pairs = float(bounds.allowed_pairs(torch.ones((1, t)), True))
    assert pairs == t * (t + 1) / 2
    want_dq = 2 * d * 3 * h * pairs / peaks.BF16_FLOPS  # ds.k with q.k and dout.v
    want_dkv = 2 * d * 4 * h * pairs / peaks.BF16_FLOPS  # ds.q, p.dout with q.k, dout.v
    want_bwd = 2 * d * 5 * h * pairs / peaks.BF16_FLOPS  # q.k, dout.v, ds.k, ds.q, p.dout
    assert bounds.attention_seconds("dq", "bfloat16", 1, t, h, h, d, pairs, 0.0) == \
        pytest.approx(want_dq, rel=1e-12)
    assert bounds.attention_seconds("dkv", "bfloat16", 1, t, h, h, d, pairs, 0.1) == \
        pytest.approx(want_dkv, rel=1e-12)
    assert bounds.attention_seconds("bwd", "bfloat16", 1, t, h, h, d, pairs, 0.1) == \
        pytest.approx(want_bwd, rel=1e-12)


def test_trace_reductions():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0)]
    assert trace.busy_us(ops) == 25.0
    assert trace.idle_gaps(ops, 0.0, 40.0) == [(15.0, 20.0), (30.0, 40.0)]
    assert trace.top_ops(ops, 2) == [["a", 10e-6], ["b", 10e-6]]
    assert trace.device_time_us(ops, ("a", "c")) == 20.0
    long_gap = [("k", 0.0, 10.0), ("k", 100.0, 110.0)]
    host = [("outer", 0.0, 200.0), ("inner", 5.0, 50.0)]
    assert trace.gaps_by_host(long_gap, host, 0.0, 110.0) == [["inner", 90e-6]]
    assert trace.gaps_by_host(ops, host, 0.0, 30.0) == [["gaps under 20 us", 5e-6]]
