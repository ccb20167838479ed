"""Port attention vs the JAX package: the plain route of attention_bthd,
and the flash route (the kernel's plain version on the CPU) against the
JAX Pallas kernel in interpret mode, with GQA and a fully masked row."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt


def make_bthd(seed, b=2, t=8, s=8, h=4, kvh=4, d=8, dead_row=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kvh, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kvh, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2:] = 0
    if dead_row:
        mask[0, :] = 0  # batch row 0: every key masked → exact zeros
    return q, k, v, mask


def run_both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize("kvh,causal", [(4, False), (2, False), (4, True)])
def test_plain_attention_bthd_matches_jax(kvh, causal):
    arrays = make_bthd(0, kvh=kvh)
    want = np.asarray(jatt.attention_bthd(*map(jnp.asarray, arrays), causal=causal,
                                          use_pallas=False))
    got = tatt.attention_bthd(*map(torch.from_numpy, arrays), causal=causal,
                              use_kernel=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kvh,dead_row", [(4, False), (2, True)])
def test_flash_route_matches_jax_pallas(monkeypatch, kvh, dead_row):
    # both gates forced down so both packages take their kernel route
    monkeypatch.setattr(jatt, "MIN_PALLAS_SEQ_LEN", 1)
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    arrays = make_bthd(1, t=12, s=12, kvh=kvh, dead_row=dead_row)
    q, k, v, mask = map(jnp.asarray, arrays)
    # the JAX kernel takes [B, H|KVH, T, D]
    want = np.asarray(jatt.flash_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                                           v.transpose(0, 2, 1, 3), mask)).transpose(0, 2, 1, 3)
    got = tatt.attention_bthd(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if dead_row:
        assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)


def test_bhtd_flash_layout_matches_bthd():
    q, k, v, mask = map(torch.from_numpy, make_bthd(2, kvh=2))
    a = tatt.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask)
    b = tatt.flash_attention_bthd(q, k, v, mask)
    np.testing.assert_array_equal(a.transpose(1, 2).numpy(), b.numpy())


def test_unported_modes_raise():
    q, k, v, mask = map(torch.from_numpy, make_bthd(3))
    with pytest.raises(ValueError, match="causal"):
        tatt.flash_attention_bthd(q, k, v, mask, causal=False, pack_len=4)
    # the kernel launchers take CUDA tensors only: no CPU fallback inside
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_forward_kernel(q, k, v, mask, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_forward_causal_kernel(q, k, v, mask, 0.125)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_backward_kernel(q, k, v, mask, q, lse, q, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_backward_causal_kernel(q, k, v, mask, q, lse, q, 0.125)
