"""The least time of a flash launch whose q and k are wider than its v
(multi-head latent attention's (192, 128)) on one H100, as
``bounds.attention_seconds`` counts it for one width: the larger of the
bytes it must move over HBM's rate and its products and exponentials over
their peaks. Each allowed (q, k) pair costs 2·DQK flops in every product
over the q/k width (q·k, ds·k, ds·q) and 2·DV in every product over the v
width (dout·v, p·v, p·dout)."""

from __future__ import annotations

from portbench.yardstick import bounds, peaks

# products of a pair over the q/k width and over the v width, by kernel
PRODUCTS = {"fwd": (1, 1), "bwd": (3, 2), "dq": (2, 1), "dkv": (2, 2)}


def attention_seconds(kind: str, dtype: str, b: int, t: int, h: int, kvh: int, dqk: int,
                      dv: int, pairs: float) -> float:
    """The bound of one launch of ``kind`` on q ``[b, t, h, dqk]``, k ``[b,
    t, kvh, dqk]`` and v ``[b, t, kvh, dv]`` scoring ``pairs`` (q, k) pairs
    a head (``bounds.allowed_pairs``), without dropout."""
    elt = 2 if dtype == "bfloat16" else 4
    pairs = h * float(pairs)
    n_qk, n_v = PRODUCTS[kind]
    seconds = [2.0 * (n_qk * dqk + n_v * dv) * pairs / bounds.ATTN_FLOPS[dtype],
               pairs / peaks.MUFU_PER_S]
    q, k, v = b * t * h * dqk * elt, b * t * kvh * dqk * elt, b * t * kvh * dv * elt
    o = b * t * h * dv * elt  # out, dout
    mask, lse = b * t * 4, b * h * t * 4
    if kind == "fwd":  # q, k, v, mask in; out, lse out
        nbytes = q + k + v + mask + o + lse
    elif kind == "dq":  # q, k, v, mask, out, dout, lse in; dq out
        nbytes = 2 * q + k + v + mask + 2 * o + lse
    elif kind == "bwd":  # the same in; dq, dk, dv out
        nbytes = 2 * q + 2 * k + 2 * v + mask + 2 * o + lse
    elif kind == "dkv":  # the same in; dk, dv (f32 per q-head) and delta out
        nbytes = q + k + v + mask + 2 * o + 2 * lse + b * t * h * (dqk + dv) * 4
    else:
        raise ValueError(f"unknown attention kernel kind {kind!r}")
    return bounds.bound_seconds(nbytes, seconds)
