"""Port dropout masks vs the JAX package, bit for bit: the flat-element
hash of ``ops/dropout.dropout`` and the attention position hash
(``_keep_from_positions``, head index b·H + h) for given int32 seeds,
including negative seeds and seeds at the int32 edges (wraparound)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu.ops.dropout as jdrop
import aat_tpu_torch.ops.attention as tatt
import aat_tpu_torch.ops.dropout as tdrop

SEEDS = [0, 1, -1, -987654321, 2**31 - 1, 2**31 - 2, -(2**31)]
RATES = [0.0, 0.1, 0.5]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_element_dropout_matches_jax(monkeypatch, seed, rate):
    # JAX draws the int32 seed from its key; pin that draw to `seed`
    monkeypatch.setattr(jdrop.jax.random, "bits",
                        lambda key, dtype: jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32))
    x = np.random.default_rng(abs(seed) % 1000).normal(0, 1, (3, 7, 33)).astype(np.float32)
    want = np.asarray(jdrop.dropout(jax.random.PRNGKey(0), jnp.asarray(x), rate))
    got = tdrop.dropout(seed, torch.from_numpy(x), rate).numpy()
    np.testing.assert_array_equal(got, want)


def test_element_dropout_with_a_drawn_key_seed():
    """Through a real key: the port given the seed JAX drew equals JAX."""
    key = jax.random.PRNGKey(17)
    seed = int(jax.random.bits(key, dtype=jnp.uint32).astype(jnp.int32))
    x = np.random.default_rng(1).normal(0, 1, (4, 129)).astype(np.float32)
    want = np.asarray(jdrop.dropout(key, jnp.asarray(x), 0.25))
    np.testing.assert_array_equal(tdrop.dropout(seed, torch.from_numpy(x), 0.25).numpy(), want)


def test_element_dropout_bf16_matches_jax(monkeypatch):
    monkeypatch.setattr(jdrop.jax.random, "bits",
                        lambda key, dtype: jnp.asarray(12345, jnp.uint32))
    x = np.random.default_rng(2).normal(0, 1, (5, 64)).astype(np.float32)
    want = np.asarray(jdrop.dropout(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16), 0.1)
                      .astype(jnp.float32))
    got = tdrop.dropout(12345, torch.from_numpy(x).to(torch.bfloat16), 0.1).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_position_hash_matches_jax(seed, rate):
    b_h, t, s = 6, 37, 29
    head = jnp.arange(b_h, dtype=jnp.int32).reshape(b_h, 1, 1)
    seed_and_head = jnp.int32(seed) + head * jatt._GOLDEN
    want = np.asarray(jatt._keep_from_positions(
        seed_and_head, jnp.arange(t, dtype=jnp.int32)[:, None],
        jnp.arange(s, dtype=jnp.int32)[None, :], s, rate))
    got = tdrop.keep_from_positions(
        tdrop.head_seeds(seed, b_h).reshape(b_h, 1, 1), torch.arange(t)[:, None],
        torch.arange(s)[None, :], s, rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [-5, 2**31 - 1])
def test_reference_attention_dropout_matches_jax(seed):
    """The plain route's mask keys on the flattened batch·head index and the
    unpadded key length."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 11, 3, 8
    q, k, v = (rng.normal(0, 1, (b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[1, 7:] = 0
    want = np.asarray(jatt._reference_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)), jnp.asarray(mask),
        False, d ** -0.5, 0.3, seed)).transpose(0, 2, 1, 3)
    got = tatt.reference_attention_bthd(*map(torch.from_numpy, (q, k, v, mask)),
                                        dropout_rate=0.3, dropout_seed=seed).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fold_seed_and_uniform():
    """Host seed derivation: deterministic int32, distinct per site, and the
    uniform draw LayerDrop uses lies in [0, 1) with the right mean."""
    seeds = [tdrop.fold_seed(42, step, mb) for step in range(50) for mb in range(4)]
    assert seeds == [tdrop.fold_seed(42, step, mb) for step in range(50) for mb in range(4)]
    assert len(set(seeds)) == len(seeds)
    assert all(-(2**31) <= s < 2**31 for s in seeds)
    u = np.array([tdrop.uniform_from_seed(s) for s in seeds])
    assert np.all((u >= 0) & (u < 1)) and abs(u.mean() - 0.5) < 0.06
