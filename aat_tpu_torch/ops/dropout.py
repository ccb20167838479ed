"""Inverted dropout for the training path (counterpart of
``aat_tpu/ops/dropout.py`` and of the position hash in
``aat_tpu/ops/attention.py:103-125``).

Both masks come from the murmur3 finalizer on 32-bit integers. The JAX
package computes it in int32 with two's-complement wraparound and logical
right shifts; torch's ``>>`` on int32 is arithmetic, so here the same bits
are computed in int64, masked to the low 32 bits after every step. For the
same int32 seed the masks equal the JAX package's bit for bit.

On a CUDA tensor the element dropout runs as one kernel
(``csrc/dropout.cu``: ``aat_dropout_fwd``, and ``aat_dropout_bwd``, which
regenerates the mask from the seed, so nothing is saved for the backward),
computing the same bits in uint32; a CPU tensor takes the int64 version,
:func:`dropout_reference`.

The port takes an int32 seed where the JAX package takes a PRNG key (it
draws the seed from the key). :func:`fold_seed` derives the seeds of the
separate dropout sites from one seed on the host, so no device value is
read to pick a seed.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from aat_tpu_torch.runtime import kernels
from aat_tpu_torch.utils import timing

_M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # per-head seed decorrelation (-1640531527 as int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), split in 16-bit
    halves of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def to_int32(x: int) -> int:
    """The int32 whose bits are the low 32 bits of ``x``."""
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x


def fold_seed(seed: int, *data: int) -> int:
    """Derive an int32 seed from ``seed`` and integers (the port's
    counterpart of ``jax.random.fold_in``, on the host)."""
    for d in data:
        seed = _mix32_int((seed & _M32) ^ _mix32_int(d * GOLDEN + 0x7F4A7C15))
    return to_int32(seed)


def uniform_from_seed(seed: int) -> float:
    """One uniform draw in [0, 1) from an int32 seed, by the masks' rule."""
    return (_mix32_int(seed) >> 8) / float(1 << 24)


def _uniform24(h: torch.Tensor) -> torch.Tensor:
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: the JAX package's
    weakly typed scalars take the array's dtype first. A Python scalar
    (rather than a device tensor) costs the host no copy to the device,
    which would wait for the device's queue to drain."""
    return torch.tensor(value, dtype=dtype).item()


def keep_from_positions(seed_and_head: torch.Tensor, q_pos: torch.Tensor,
                        k_pos: torch.Tensor, s_stride: int, rate: float) -> torch.Tensor:
    """Attention-dropout keep mask keyed on absolute (q, k) positions
    (``_keep_from_positions``): ``mix32((q·S + k) ^ (seed + bh·GOLDEN))``,
    keep where its top 24 bits as a uniform are ``>= rate``. Arguments
    broadcast; ``seed_and_head`` holds the uint32 bits in int64."""
    x = (q_pos.to(torch.int64) * s_stride + k_pos.to(torch.int64)) & _M32
    return _uniform24(mix32(x ^ (seed_and_head & _M32))) >= _as(rate, torch.float32)


def head_seeds(seed: int, n_heads_flat: int, device=None, n_heads: Optional[int] = None,
               head_keys: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``seed + bh·GOLDEN`` (mod 2**32) for the flattened batch·head index
    ``bh`` in ``[0, n_heads_flat)``, as int64. With ``head_keys =
    (heads_total, head_offset)``, the ``n_heads`` heads of a batch row are
    heads ``head_offset, head_offset + 1, ...`` of ``heads_total`` and
    ``bh`` is their global index b·heads_total + head_offset + h."""
    bh = torch.arange(n_heads_flat, dtype=torch.int64, device=device)
    if head_keys is not None:
        total, offset = head_keys
        bh = bh // n_heads * total + offset + bh % n_heads
    return ((seed & _M32) + bh * GOLDEN) & _M32


class ElementShard(NamedTuple):
    """Where a rank's tensor sits in the global one its masks are keyed on
    (multi-device training): dim 0 is block ``row_block`` of equal row
    blocks; with ``time = (t0, t_full)`` dim 1 holds positions ``t0,
    t0 + 1, ...`` of ``t_full`` (positions at or past ``t_full`` are
    padding); with ``cols = (c0, c_full)`` the last dim holds columns ``c0,
    c0 + 1, ...`` of ``c_full`` (a tensor-parallel column shard)."""

    row_block: int = 0
    time: Optional[Tuple[int, int]] = None
    cols: Optional[Tuple[int, int]] = None


def _placement(shape, shard: Optional[ElementShard]):
    """``(offset, global extent)`` of every dim of a tensor of ``shape``
    that ``shard`` places; dim 0's extent is never used."""
    if shard is None:
        return [(0, d) for d in shape]
    if (shard.time is not None and len(shape) < 2) or (
            shard.cols is not None and len(shape) < (3 if shard.time else 2)):
        raise ValueError(f"{shard} does not place a tensor of shape {tuple(shape)}")
    place = [(shard.row_block * shape[0], shape[0])] + [(0, d) for d in shape[1:]]
    if shard.time is not None:
        place[1] = shard.time
    if shard.cols is not None:
        place[-1] = shard.cols
    return place


def _flat_index(shape, shard: Optional[ElementShard], device) -> torch.Tensor:
    """The element's flat index in the global tensor, int64, modulo 2**32:
    each dim's global coordinate (its local one plus the shard's offset)
    in row-major order over the global extents."""
    n = 1
    for d in shape:
        n *= d
    if shard is None:
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    place = _placement(shape, shard)
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for dim, (size, (offset, extent)) in enumerate(zip(shape, place)):
        coord = torch.arange(size, dtype=torch.int64, device=device) + offset
        idx = idx[..., None] * extent + coord.reshape((1,) * dim + (size,))
    return idx & _M32


def shift_head_seed(seed: int, rows_before: int, heads: int) -> int:
    """The attention seed of a batch slice that starts at global row
    ``rows_before``: the kernels key a head on ``seed + bh·GOLDEN`` with the
    slice's own index ``bh``, which is the global one less ``rows_before ·
    heads``, so this seed gives the global batch's masks."""
    return to_int32(seed + rows_before * heads * GOLDEN)


def keep_threshold(rate: float) -> int:
    """The kernel's ``keep_min``: an element is kept where the top 24 bits
    of its hash are ``>= ceil(float32(rate)·2^24)``, which is exactly
    ``_uniform24(h) >= float32(rate)`` since ``(h >> 8)·2^-24`` is exact in
    float32 (and the product here exact in float64)."""
    return math.ceil(_as(rate, torch.float32) * (1 << 24))


@functools.lru_cache(maxsize=64)
def _rate_args(rate: float, dtype: torch.dtype):
    """``keep_min`` and the scale 1/(1 - rate) rounded to ``dtype``: each
    rounding makes a tensor on the host, so a step's hundreds of calls at a
    few rates take them from here."""
    return keep_threshold(rate), _as(1.0 / (1.0 - rate), dtype)


# the kernel's dtype codes (csrc/dropout.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_DIMS = 4


def _kernel_dims(shape, shard: Optional[ElementShard]):
    """``(local size, global offset, global extent)`` of the dims the
    kernel walks: :func:`_placement`'s, with every dim that lies whole in
    its global one (offset 0, extent its size) merged into the dim before
    it, which gives the same flat indices in fewer dims (one, for an
    unplaced tensor)."""
    dims = []
    for size, (offset, extent) in zip(shape, _placement(shape, shard)):
        if dims and offset == 0 and extent == size:
            s, o, e = dims[-1]
            dims[-1] = (s * size, o * size, e * size)
        else:
            dims.append((size, offset, extent))
    return dims or [(1, 0, 1)]


def _kernel_args(seed: int, x: torch.Tensor, rate: float, shard: Optional[ElementShard]):
    """The C entries' arguments after the two pointers and the dtype."""
    if x.dim() > _MAX_DIMS:
        raise ValueError(f"the dropout kernel takes up to {_MAX_DIMS} dims, got {x.dim()}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the dropout kernel takes {list(_DTYPES)}, got {x.dtype}")
    dims = _kernel_dims(x.shape, shard)
    pad = [(1, 0, 0)] * (_MAX_DIMS - len(dims))
    sizes, offsets, extents = zip(*(dims + pad))
    return (len(dims), *sizes, *(o & _M32 for o in offsets), *(e & _M32 for e in extents),
            to_int32(seed), *_rate_args(float(rate), x.dtype))


def _launch(entry: str, x: torch.Tensor, args) -> torch.Tensor:
    kernels.check_cuda(x, "dropout")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    kernels.launch(entry, x.device, x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], *args)
    return y


class _Dropout(torch.autograd.Function):
    """The kernel's dropout: the forward through ``aat_dropout_fwd``; the
    backward through ``aat_dropout_bwd``, which hashes the same indices with
    the same seed, so the keep mask is regenerated and nothing is saved."""

    @staticmethod
    def forward(ctx, x, args):
        ctx.args = args
        return _launch("aat_dropout_fwd", x, args)

    @staticmethod
    def backward(ctx, dy):
        return _launch("aat_dropout_bwd", dy, ctx.args), None


def dropout_reference(seed: int, x: torch.Tensor, rate: float,
                      shard: Optional[ElementShard] = None) -> torch.Tensor:
    """The plain version of :func:`dropout` (int64 hash, then a select):
    the route of a CPU tensor, and what the kernel is held to on the card."""
    idx = _flat_index(x.shape, shard, x.device)
    keep = _uniform24(mix32(idx ^ (seed & _M32))) >= _as(rate, torch.float32)
    return torch.where(keep, x * _as(1.0 / (1.0 - rate), x.dtype), 0.0)


def dropout(seed: Optional[int], x: torch.Tensor, rate: float,
            shard: Optional[ElementShard] = None) -> torch.Tensor:
    """Train-mode inverted dropout (torch semantics: zero with probability
    ``rate``, survivors scaled by 1/(1-rate)). Identity when ``seed`` is
    None or ``rate`` is 0. The keep mask hashes the flat element index:
    ``mix32(idx ^ seed)``, the index in the global tensor that ``shard``
    places ``x`` in. A CPU tensor takes :func:`dropout_reference`, any
    other the kernel (the same bits)."""
    if seed is None or rate <= 0.0:
        return x
    with timing.span("ops.dropout", device=x.is_cuda):
        if x.device.type == "cpu":
            return dropout_reference(seed, x, rate, shard)
        return _Dropout.apply(x, _kernel_args(seed, x, rate, shard))
