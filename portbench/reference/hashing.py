"""The dropout rules the ASLM's training states, written out for the
reference (a frozen copy of the port's ``ops/dropout.py`` semantics, not an
import of it): the murmur3 finalizer on 32-bit integers keyed on an
element's flat index, on a (query, key) position pair for attention
probabilities, and a host draw per layer for LayerDrop; seeds of the sites
derived from one int32 seed by ``fold_seed``.

Masks are worked out for a block of rows that starts at global row
``row0``, so the reference can run a batch in blocks and draw the masks of
the whole batch.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
HIDDEN_SITE = 1 << 16  # the encoder's dropout after the positional conv
LAYERDROP_SITE = 1 << 20  # the LayerDrop draw of a layer


def mix32_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def to_int32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >= (1 << 31) else x


def fold_seed(seed: int, *data: int) -> int:
    for d in data:
        seed = mix32_int((seed & M32) ^ mix32_int(d * GOLDEN + 0x7F4A7C15))
    return to_int32(seed)


def uniform_from_seed(seed: int) -> float:
    return (mix32_int(seed) >> 8) / float(1 << 24)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _threshold(rate: float) -> float:
    return float(torch.tensor(rate, dtype=torch.float32))


def keep_uniform(h: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep where the top 24 bits of ``h``, as a uniform in [0, 1), are at
    least ``rate`` (the rate rounded to float32)."""
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))) >= _threshold(rate)


def element_keep(seed: int, shape, rate: float, row0: int, device) -> torch.Tensor:
    """Keep mask of an element-wise dropout on rows ``[row0, row0 +
    shape[0])`` of a tensor with the same trailing dims: keyed on the
    global flat index."""
    inner = 1
    for d in shape[1:]:
        inner *= d
    idx = (torch.arange(shape[0], dtype=torch.int64, device=device)[:, None] + row0) * inner \
        + torch.arange(inner, dtype=torch.int64, device=device)[None, :]
    idx = (idx & M32).reshape(shape)
    return keep_uniform(mix32(idx ^ (seed & M32)), rate)


def dropout(seed, x: torch.Tensor, rate: float, row0: int = 0) -> torch.Tensor:
    """Inverted dropout of ``x`` (rows from global row ``row0``); identity
    without a seed or at rate 0. The survivors are scaled by ``1 / (1 -
    rate)`` in ``x``'s precision."""
    if seed is None or rate <= 0.0:
        return x
    keep = element_keep(seed, x.shape, rate, row0, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def attention_keep(seed: int, b0: int, b: int, h0: int, hc: int, heads_total: int, t: int,
                   s: int, rate: float, device) -> torch.Tensor:
    """``[b, hc, t, s]`` keep mask of the attention probabilities of rows
    ``b0 ...`` and heads ``h0 ...`` of ``heads_total``: head (b, h) keyed on
    ``seed + (b·heads_total + h)·GOLDEN``, position pair on ``q·S + k``."""
    bh = ((torch.arange(b, dtype=torch.int64, device=device)[:, None] + b0) * heads_total
          + torch.arange(hc, dtype=torch.int64, device=device)[None, :] + h0)
    seeds = (((seed & M32) + bh * GOLDEN) & M32)[:, :, None, None]
    pos = ((torch.arange(t, dtype=torch.int64, device=device)[:, None] * s
            + torch.arange(s, dtype=torch.int64, device=device)[None, :]) & M32)
    return keep_uniform(mix32(pos[None, None] ^ seeds), rate)
