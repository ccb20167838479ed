"""The least time a kernel could take on one H100: the larger of the bytes
it must move over HBM's rate and each kind of operation it must issue over
that kind's peak rate (a frozen copy of ``chip_smoke.bound_ms`` and
``attention_bound``). Each input byte is counted read once and each output
byte written once; where the work depends on the inputs (masked keys, the
causal triangle) only what these inputs need is counted."""

from __future__ import annotations

from typing import Sequence

from portbench.yardstick import peaks

# products of D-long rows per allowed (q, k) pair: the forward's q.k and p.v;
# the backward's q.k, dout.v, then dq (ds.k), dk (ds.q) and dv (p.dout)
PRODUCTS = {"fwd": 2, "bwd": 5, "dq": 3, "dkv": 4}
HASH_OPS = 10  # integer operations of the dropout position hash per score
# the flash kernels' matrix products: bf16 on the tensor cores, f32 as 3xTF32
ATTN_FLOPS = {"bfloat16": peaks.BF16_FLOPS, "float32": peaks.TF32_FLOPS / 3}


def bound_seconds(nbytes: float, op_seconds: Sequence[float]) -> float:
    """max(bytes over HBM's rate, the slowest kind of operation)."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, *op_seconds)


def allowed_pairs(key_mask, causal: bool):
    """(q, k) pairs a self-attention launch must score, per head, from its
    ``[B, S]`` key mask: only valid queries count (a padded query row is
    work no output needs); dense, each valid query sees every valid key of
    its row; causal, the valid keys at or before it. A torch scalar, on the
    mask's device."""
    import torch

    m = (key_mask > 0).to(torch.float64)
    if causal:
        return (m * m.cumsum(-1)).sum()
    return (m.sum(-1) ** 2).sum()


def attention_seconds(kind: str, dtype: str, b: int, t: int, h: int, kvh: int, d: int,
                      pairs: float, rate: float) -> float:
    """The bound of one flash launch of ``kind`` (``PRODUCTS``) on q ``[b, t,
    h, d]`` and k/v ``[b, t, kvh, d]`` that scores ``pairs`` (q, k) pairs
    per head (:func:`allowed_pairs`)."""
    elt = 2 if dtype == "bfloat16" else 4
    pairs = h * float(pairs)
    seconds = [2.0 * d * PRODUCTS[kind] * pairs / ATTN_FLOPS[dtype], pairs / peaks.MUFU_PER_S]
    if rate > 0.0:
        seconds.append(HASH_OPS * pairs / peaks.INT32_PER_S)
    q_bytes, kv_bytes, mask_bytes, lse_bytes = b * t * h * d * elt, b * t * kvh * d * elt, b * t * 4, b * h * t * 4
    if kind == "fwd":  # q, k, v, mask in; out, lse out
        nbytes = 2 * q_bytes + 2 * kv_bytes + mask_bytes + lse_bytes
    elif kind == "dq":  # q, k, v, mask, out, dout, lse in; dq out
        nbytes = 4 * q_bytes + 2 * kv_bytes + mask_bytes + lse_bytes
    elif kind == "bwd":  # q, k, v, mask, out, dout, lse in; dq, dk, dv out
        nbytes = 4 * q_bytes + 4 * kv_bytes + mask_bytes + lse_bytes
    elif kind == "dkv":  # q, k, v, mask, out, dout, lse in; dk, dv (f32 per q-head) and delta out
        nbytes = 3 * q_bytes + 2 * kv_bytes + mask_bytes + 2 * lse_bytes + 2 * b * t * h * d * 4
    else:
        raise ValueError(f"unknown attention kernel kind {kind!r}")
    return bound_seconds(nbytes, seconds)

