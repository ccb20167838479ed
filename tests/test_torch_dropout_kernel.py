"""The element dropout's kernel route (``csrc/dropout.cu``: ``aat_dropout_fwd``
and ``aat_dropout_bwd``), on the CPU:

- the threshold ``keep_min`` the kernel compares the hash's top 24 bits
  with is exactly the plain version's float32 comparison, at every value
  next to it;
- on the meta device, with a library that records the C entries it is
  asked for, a card tensor reaches ``aat_dropout_fwd`` with the seed's
  bits, ``keep_min``, the scale rounded to its dtype and the dims of each
  ``ElementShard`` case (rows, time with padding, columns, a 4-D tensor),
  and its backward reaches ``aat_dropout_bwd`` with the same arguments;
  the kernel's index and keep rule, applied to those arguments, reproduce
  the plain version bit for bit; a rank-5 tensor and a float64 one raise;
  a CPU tensor takes the plain version and calls no C entry.

The C declarations are held against the ctypes signatures with every other
entry's (``test_torch_flash_fwd_mma.test_c_entries_match_ctypes_signatures``);
``chip_smoke.py`` holds the kernel to the plain version on the card."""

import numpy as np
import pytest
import torch

from aat_tpu_torch.ops import dropout as tdrop
from aat_tpu_torch.ops.dropout import ElementShard
from test_torch_flash_fwd_mma import meta_library  # noqa: F401  (the fixture)

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.3, 0.5, 3 / 1024, 0.999])
def test_keep_threshold_is_the_float32_comparison(rate):
    """keep_min = ceil(float32(rate)·2^24): (h >> 8) >= keep_min exactly where
    the plain version's uniform (h >> 8)·2^-24 >= float32(rate)."""
    k = tdrop.keep_threshold(rate)
    tops = torch.arange(max(k - 3, 0), min(k + 3, 1 << 24), dtype=torch.int64)
    h = (tops << 8) | 0xA5
    plain = tdrop._uniform24(h) >= tdrop._as(rate, torch.float32)
    assert torch.equal(plain, tops >= k)
    assert plain.any() and not plain.all()


def kernel_output(args, x):
    """What the kernel computes from its arguments (after the pointers and
    the dtype) on ``x``, in uint32 arithmetic as ``dropout.cu`` does:
    ``global_index`` over the dims, ``mix32(idx ^ seed) >> 8 >= keep_min``,
    survivors ``float(x)·scale`` rounded once to x's dtype."""
    ndim, sizes, offsets, extents = args[0], args[1:5], args[5:9], args[9:13]
    seed, keep_min, scale = args[13:16]
    i = np.arange(x.numel(), dtype=np.uint64)
    idx, mult = np.zeros_like(i), 1
    for d in range(ndim - 1, 0, -1):
        idx = (idx + ((i % np.uint64(sizes[d]) + np.uint64(offsets[d])) & M32)
               * np.uint64(mult)) & M32
        mult = (mult * extents[d]) & M32
        i //= np.uint64(sizes[d])
    idx = (idx + ((i + np.uint64(offsets[0])) & M32) * np.uint64(mult)) & M32
    h = tdrop.mix32(torch.from_numpy(idx.astype(np.int64)) ^ (seed & M32))
    keep = ((h >> 8) >= keep_min).reshape(x.shape)
    return torch.where(keep, (x.float() * scale).to(x.dtype), 0.0)


# (local shape, shard, the kernel's dims: (size, offset, extent) each)
SHARDS = {
    "none": ((3, 7, 33), None, [(693, 0, 693)]),
    "rows": ((4, 19, 12), ElementShard(1), [(912, 912, 912)]),
    "time": ((8, 10, 12), ElementShard(0, (10, 19)), [(8, 0, 8), (120, 120, 228)]),
    "time_rows": ((4, 10, 12), ElementShard(1, (0, 19)), [(4, 4, 4), (120, 0, 228)]),
    "cols": ((8, 19, 6), ElementShard(0, None, (6, 12)), [(152, 0, 152), (6, 6, 12)]),
    "rows_cols": ((4, 19, 3), ElementShard(1, None, (9, 12)), [(76, 76, 76), (3, 9, 12)]),
    "all": ((4, 10, 6), ElementShard(1, (10, 19), (6, 12)), [(4, 4, 4), (10, 10, 19),
                                                            (6, 6, 12)]),
    "4d": ((2, 3, 5, 8), ElementShard(1, (3, 7), (8, 16)), [(2, 2, 2), (15, 15, 35),
                                                           (8, 8, 16)]),
    "4d_none": ((2, 3, 5, 8), None, [(240, 0, 240)]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("seed, rate", [(-(2**31), 0.1), (2**31 - 1, 0.5), (-7, 0.3)])
@pytest.mark.parametrize("case", SHARDS)
def test_card_tensor_reaches_the_kernel(meta_library, case, seed, rate, dtype):
    shape, shard, dims = SHARDS[case]
    x = torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)
    y = tdrop.dropout(seed, x, rate, shard)
    assert meta_library.names == ["aat_dropout_fwd"]
    assert y.shape == x.shape and y.dtype == dtype and y.device.type == "meta"
    args = meta_library.args[0][2:-1]
    pad = [(1, 0, 0)] * (4 - len(dims))
    sizes, offsets, extents = zip(*(dims + pad))
    assert args == (tdrop._DTYPES[dtype], len(dims), *sizes, *offsets, *extents, seed,
                    tdrop.keep_threshold(rate), tdrop._as(1 / (1 - rate), dtype))
    # the backward regenerates the mask from the same arguments
    (torch.autograd.grad(y, x, torch.ones_like(y)))
    assert meta_library.names == ["aat_dropout_fwd", "aat_dropout_bwd"]
    assert meta_library.args[1][2:-1] == meta_library.args[0][2:-1]
    # the kernel's rule on those arguments is the plain version, bit for bit
    cpu = torch.from_numpy(np.random.default_rng(len(case)).normal(0, 1, shape)).to(dtype)
    want = tdrop.dropout_reference(seed, cpu, rate, shard)
    got = kernel_output(args[1:], cpu)
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32 else torch.int32),
                       want.view(torch.int16 if dtype != torch.float32 else torch.int32))


def test_a_non_contiguous_card_tensor_goes_through_a_copy(meta_library):
    x = torch.empty((33, 7, 3), dtype=torch.bfloat16, device="meta").permute(2, 1, 0)
    assert not x.is_contiguous()
    y = tdrop.dropout(5, x, 0.1)
    assert meta_library.names == ["aat_dropout_fwd"] and y.shape == (3, 7, 33)
    assert meta_library.args[0][3:5] == (1, 693)


@pytest.mark.parametrize("shape, dtype", [((2, 2, 2, 2, 2), torch.bfloat16),
                                          ((4, 8), torch.float64)],
                         ids=["rank5", "float64"])
def test_what_the_kernel_does_not_take_raises(meta_library, shape, dtype):
    x = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="dropout kernel"):
        tdrop.dropout(1, x, 0.1)
    assert meta_library.names == []


def test_a_cpu_tensor_takes_the_plain_version(meta_library):
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (5, 9, 16)).astype(np.float32))
    x.requires_grad_(True)
    y = tdrop.dropout(99, x, 0.25, ElementShard(1, (9, 20)))
    (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert meta_library.names == []
    assert torch.equal(y, tdrop.dropout_reference(99, x, 0.25, ElementShard(1, (9, 20))))
    assert torch.equal(g, (y != 0).float() * tdrop._as(1 / 0.75, torch.float32))
