"""Port flash attention in training: forward (out and row lse) and
gradients against ``jax.vjp`` of the JAX package's ``flash_attention``
(Pallas kernels in interpret mode), dense and causal, with GQA, a padded
key tail, a fully masked row, position-hash dropout and ``pack_len``. On
the CPU the port runs the kernels' plain versions; the plain backward is
also held against autograd through the plain forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt

# name: (causal, H, KVH, dead_row, dropout (rate, seed) or None, pack_len)
CASES = {
    "dense": (False, 4, 4, False, None, None),
    "dense_gqa_dead_dropout": (False, 4, 2, True, (0.3, -123456789), None),
    "causal_gqa_tail": (True, 4, 2, False, None, None),
    "causal_dropout_pack": (True, 2, 1, True, (0.1, 2**31 - 1), 8),
}


def make_case(seed, b=2, t=16, h=4, kvh=4, d=8, dead_row=False):
    """q [B, T, H, D], k/v [B, T, KVH, D], a padded key tail on row 1, a
    cotangent for the output."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32)
    g = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 5:] = 0
    if dead_row:
        mask[0, :] = 0
    return q, k, v, mask, g


def jax_flash(q, k, v, mask, g, causal, dropout, pack_len):
    """(out, lse [B, H, T], dq, dk, dv) of the JAX Pallas route, as numpy in
    the [B, T, H, D] layout."""
    rate, seed = dropout if dropout else (0.0, None)
    qj, kj, vj = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    maskj = jnp.asarray(mask)
    b, h, t, _ = qj.shape
    scale = q.shape[-1] ** -0.5
    _, lse, _ = jatt._flash_forward(qj, kj, vj, maskj, causal, scale, dropout_rate=rate,
                                    dropout_seed=None if seed is None else jnp.int32(seed),
                                    pack_len=pack_len)
    lse = np.asarray(lse)[:, :t, 0].reshape(b, h, t)

    def f(q_, k_, v_):
        return jatt.flash_attention(q_, k_, v_, maskj, causal, None, rate, seed, pack_len)

    out, vjp = jax.vjp(f, qj, kj, vj)
    grads = vjp(jnp.asarray(g).transpose(0, 2, 1, 3))
    t_ = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    return (t_(out), lse) + tuple(t_(x) for x in grads)


def port_flash(q, k, v, mask, g, causal, dropout, pack_len):
    rate, seed = dropout if dropout else (0.0, None)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    maskt = torch.from_numpy(mask)
    scale = q.shape[-1] ** -0.5
    _, lse = tatt.flash_forward_reference(qt.detach(), kt.detach(), vt.detach(), maskt,
                                          scale, causal, rate, seed or 0, pack_len)
    out = tatt.flash_attention_bthd(qt, kt, vt, maskt, causal, None, rate, seed, pack_len)
    out.backward(torch.from_numpy(g))
    return (out.detach().numpy(), lse.numpy(), qt.grad.numpy(), kt.grad.numpy(),
            vt.grad.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_train_matches_jax_pallas(name):
    causal, h, kvh, dead_row, dropout, pack_len = CASES[name]
    arrays = make_case(sum(map(ord, name)), h=h, kvh=kvh, dead_row=dead_row)
    want = jax_flash(*arrays, causal, dropout, pack_len)
    got = port_flash(*arrays, causal, dropout, pack_len)
    for label, a, b, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                                (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=label)
    if dead_row:  # exact zeros forward, zero gradients backward
        assert np.all(got[0][0] == 0.0) and np.all(got[1][0] == -1e30)
        assert np.all(got[2][0] == 0.0)
        assert all(np.all(np.isfinite(x)) for x in got[2:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd(name):
    causal, h, kvh, dead_row, dropout, pack_len = CASES[name]
    q, k, v, mask, g = map(torch.from_numpy, make_case(7, h=h, kvh=kvh, dead_row=dead_row))
    rate, seed = dropout if dropout else (0.0, None)
    scale = q.shape[-1] ** -0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tatt.reference_attention_bthd(*leaves, mask, scale, causal, rate, seed, pack_len)
    ref.backward(g)
    out, lse = tatt.flash_forward_reference(q, k, v, mask, scale, causal, rate, seed or 0,
                                            pack_len)
    grads = tatt.flash_backward_reference(q, k, v, mask, out, lse, g, scale, causal, rate,
                                          seed or 0, pack_len)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=1e-6, rtol=0)
    for label, a, leaf in zip(("dq", "dk", "dv"), grads, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=0,
                                   err_msg=label)


def test_bf16_flash_gradients_close_to_jax():
    """bf16 operands: both sides round p and ds to bf16 before the products
    but sum in other orders, so the bar is a bf16 one (3e-2 of max|ref|)."""
    q, k, v, mask, g = make_case(11, h=4, kvh=2)
    bf = lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k, v, g = map(bf, (q, k, v, g))
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3) for x in (q, k, v))
    out_j, vjp = jax.vjp(lambda a, b_, c: jatt.flash_attention(a, b_, c, jnp.asarray(mask),
                                                               True), qj, kj, vj)
    want = [np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3)
            for x in (out_j,) + vjp(jnp.asarray(g, jnp.bfloat16).transpose(0, 2, 1, 3))]
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    out = tatt.flash_attention_bthd(*leaves, torch.from_numpy(mask), causal=True)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    got = [out.detach().float().numpy()] + [x.grad.float().numpy() for x in leaves]
    for label, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=3e-2 * np.abs(b).max(), rtol=0, err_msg=label)


def test_no_grad_takes_lse_free_forward(monkeypatch):
    """Serving (no gradient) never saves residuals: the autograd Function is
    not entered."""
    q, k, v, mask, _ = map(torch.from_numpy, make_case(3))
    calls = []
    monkeypatch.setattr(tatt._FlashCore, "apply", lambda *a: calls.append(a))
    out = tatt.flash_attention_bthd(q, k, v, mask)
    assert not calls
    np.testing.assert_array_equal(out.numpy(), tatt.reference_attention_bthd(q, k, v, mask).numpy())
