"""The split flash backward (key lengths above ``FUSED_BWD_MAX_S``) against
``jax.vjp`` of the JAX package's ``flash_attention`` with its split route
forced: ``_FUSED_BWD_MAX_S`` patched to 128, so at T = S = 300 the JAX
backward runs ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (Pallas in
interpret mode). On the CPU the port's backward is its plain version
whatever the key length; the split plain versions equal it bit for bit,
and the dispatch to the split route's wrappers is checked on the meta
device. Tolerances as in test_torch_flash_train.py."""

import functools

import numpy as np
import pytest
import torch

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt
from tests.test_torch_flash_train import jax_flash, make_case, port_flash

# name: (causal, H, KVH, D, dead_row, dropout (rate, seed) or None, pack_len)
CASES = {
    "dense_dropout_tail_dead": (False, 2, 2, 32, True, (0.1, 987654321), None),
    "causal_gqa": (True, 4, 2, 32, False, None, None),
    "causal_pack": (True, 2, 2, 32, False, None, 100),
    "dense_d128": (False, 2, 1, 128, False, None, None),
}


def counting(calls, name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_backward_matches_jax_split_kernels(monkeypatch, name):
    causal, h, kvh, d, dead_row, dropout, pack_len = CASES[name]
    calls = []
    monkeypatch.setattr(jatt, "_FUSED_BWD_MAX_S", 128)
    for fn in ("_bwd_dq_kernel", "_bwd_dkv_kernel", "_bwd_fused_kernel",
               "_bwd_fused_tri_kernel"):
        monkeypatch.setattr(jatt, fn, counting(calls, fn, getattr(jatt, fn)))
    arrays = make_case(sum(map(ord, name)), b=2, t=300, h=h, kvh=kvh, d=d, dead_row=dead_row)
    want = jax_flash(*arrays, causal, dropout, pack_len)
    got = port_flash(*arrays, causal, dropout, pack_len)
    # the JAX side ran its split kernels and not the fused ones
    assert sorted(set(calls)) == ["_bwd_dkv_kernel", "_bwd_dq_kernel"]
    for label, a, b, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                                (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=label)
    if dead_row:  # exact zeros forward, zero gradients backward
        assert np.all(got[0][0] == 0.0) and np.all(got[2][0] == 0.0)


def test_split_reference_halves_equal_the_whole():
    """The split route's plain versions give the fused plain version's
    gradients bit for bit (the same arithmetic in two passes)."""
    q, k, v, mask, g = map(torch.from_numpy, make_case(3, t=40, h=4, kvh=2, d=16))
    scale = 16 ** -0.5
    out, lse = tatt.flash_forward_reference(q, k, v, mask, scale, True, 0.2, 77, 20)
    args = (q, k, v, mask, out, lse, g, scale, True, 0.2, 77, 20)
    whole = tatt.flash_backward_reference(*args)
    split = (tatt.flash_backward_dq_reference(*args), *tatt.flash_backward_dkv_reference(*args))
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


def test_split_wrappers_refuse_cpu_tensors():
    q, k, v, mask, g = map(torch.from_numpy, make_case(4, t=8, d=64))
    out, lse = tatt.flash_forward_reference(q, k, v, mask, 0.125)
    for wrapper in (tatt.flash_backward_dq_long, tatt.flash_backward_dkv_long):
        before = wrapper.launches
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q, k, v, mask, out, lse, g, 0.125)
        assert wrapper.launches == before


# key length, causal → the wrappers the backward launches on a device tensor
DISPATCH = {
    (tatt.FUSED_BWD_MAX_S, False): ["flash_backward_kernel"],
    (tatt.FUSED_BWD_MAX_S, True): ["flash_backward_causal_kernel"],
    (tatt.FUSED_BWD_MAX_S + 1, False): ["flash_backward_dq_long", "flash_backward_dkv_long"],
    (tatt.FUSED_BWD_MAX_S + 1, True): ["flash_backward_dq_long", "flash_backward_dkv_long"],
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("s, causal", sorted(DISPATCH))
def test_backward_dispatch_by_key_length(monkeypatch, device, s, causal):
    """On a CPU tensor the backward is the plain version at any key length.
    On a device tensor (the meta device: shapes without data) it launches
    the split route's two wrappers above ``FUSED_BWD_MAX_S`` and the fused
    wrapper at or below it, and nothing else."""
    calls = []
    fakes = {"flash_backward_reference": lambda *a, **kw: a[:3],
             "flash_backward_kernel": lambda *a, **kw: a[:3],
             "flash_backward_causal_kernel": lambda *a, **kw: a[:3],
             "flash_backward_dq_long": lambda *a, **kw: a[0],
             "flash_backward_dkv_long": lambda *a, **kw: a[1:3]}
    for fn, fake in fakes.items():
        monkeypatch.setattr(tatt, fn, counting(calls, fn, fake))
    q, k, v, g = (torch.empty((1, s, 2, 64), device=device) for _ in range(4))
    mask = torch.ones((1, s), dtype=torch.int32, device=device)
    lse = torch.empty((1, 2, s), device=device)
    dq, dk, dv = tatt.flash_backward(q, k, v, mask, q, lse, g, 0.125, causal, 0.0, 0, None)
    assert all(a is b for a, b in zip((dq, dk, dv), (q, k, v)))
    assert calls == (["flash_backward_reference"] if device == "cpu" else DISPATCH[s, causal])
