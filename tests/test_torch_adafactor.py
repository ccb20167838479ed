"""The port's unfused optimizer pieces against the JAX package's on seeded
gradients: ``adamw_grouped`` (clip, the two decay groups, the freeze),
``guard_nonfinite`` (with its folded clip), ``adafactor`` (optax under the
JAX package's settings: 12 steps with and without a freeze mask, relative
step and explicit learning rate, within rtol 1e-5 / atol 1e-7 of JAX; and
the ``transformers`` Adafactor oracle of ``tests/test_adafactor.py`` at its
rtol 1e-4 / atol 1e-6), and ``merge_matching_state``.

Reading of the 1e-5: the two packages reduce the factored means in another
order and XLA's f32 ``pow`` may be an ulp off torch's, so a step's update
may differ by a few float32 ulps of its size; over 12 steps of updates of
about 1e-2 relative that stays near 1e-6 of the parameter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aat_tpu.training import optim as joptim
from aat_tpu.training.lr_schedule import warmup_linear_schedule as jsched
from aat_tpu_torch.training import optim as toptim
from aat_tpu_torch.training.lr_schedule import warmup_linear_schedule as tsched
from test_torch_optim import small_tree

STEPS = 12


def to_torch(tree):
    return toptim.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def adafactor_tree(seed=0):
    """Kernels of 2 and 3 dimensions (a conv-like [K, C, C] with ties in
    the shape), biases and norm scales, and a frozen LM."""
    tree = small_tree(seed)
    rng = np.random.default_rng(seed + 10)
    tree["audio_encoder"]["conv"] = {"kernel": rng.normal(0, 0.5, (3, 6, 6)).astype(np.float32)}
    tree["adapter"]["wide"] = {"kernel": rng.normal(0, 0.5, (5, 9, 2)).astype(np.float32)}
    return tree


def run_both(jtx, ttx, params, grads_of, freeze=None):
    """Parameters of both packages after applying ``jtx`` / ``ttx`` to the
    same gradients; frozen leaves get zero gradients in JAX, ``None`` in
    the port (as the trainers give them)."""
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = to_torch(params)
    js, ts = jtx.init(jparams), ttx.init(tparams)
    for step in range(STEPS):
        grads = grads_of(step)
        if freeze is not None:
            grads = jax.tree.map(lambda g, t: g if t else np.zeros_like(g), grads, freeze)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, grads), js, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tgrads = toptim.tree_map(
            lambda g, t: torch.from_numpy(np.array(g)) if t else None, grads,
            freeze if freeze is not None else jax.tree.map(lambda _: True, grads))
        tu, ts = ttx.update(tgrads, ts, tparams)
        toptim.apply_updates(tparams, tu)
    return jparams, tparams, js, ts


def seeded_grads(params, seed=3, nan_step=None):
    rng = np.random.default_rng(seed)
    draws = [jax.tree.map(lambda p: rng.normal(0, 0.1, p.shape).astype(np.float32), params)
             for _ in range(STEPS)]
    if nan_step is not None:
        draws[nan_step]["adapter"]["bias"][1] = np.nan
    return lambda step: draws[step]


def assert_params_close(jparams, tparams, rtol, atol):
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree.leaves(toptim.tree_map(lambda x: x.numpy(), tparams))  # JAX's leaf order
    assert len(flat) == len(got)
    for (path, a), b in zip(flat, got):
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("lr", ["relative", "schedule"])
def test_adafactor_matches_jax(frozen, lr):
    params = adafactor_tree()
    freeze = joptim.trainable_mask(params, train_audio_encoder=True,
                                   train_lm_decoder=False) if frozen else None
    jlr, tlr = (None, None) if lr == "relative" else (jsched(1e-2, 3, 12), tsched(1e-2, 3, 12))
    jparams, tparams, js, ts = run_both(
        joptim.adafactor(jlr, freeze=freeze), toptim.adafactor(tlr, freeze=freeze),
        params, seeded_grads(params), freeze)
    assert_params_close(jparams, tparams, rtol=1e-5, atol=1e-7)
    assert int(ts.count) == STEPS
    # the factored slots have optax's shapes; 1-D leaves keep v
    fac = toptim.factored_dims((3, 6, 6))
    assert fac == (1, 2) and tuple(ts.v_row["audio_encoder"]["conv"]["kernel"].shape) == (3, 6)
    assert ts.v["adapter"]["bias"] is not None and ts.v_row["adapter"]["bias"] is None
    if frozen:
        assert ts.v_row["lm_decoder"]["kernel"] is None
        np.testing.assert_array_equal(tparams["lm_decoder"]["kernel"].numpy(), 1.0)


def test_guarded_adafactor_drops_a_nonfinite_step_as_jax():
    params = adafactor_tree(1)
    jparams, tparams, js, ts = run_both(
        joptim.guard_nonfinite(joptim.adafactor()), toptim.guard_nonfinite(toptim.adafactor()),
        params, seeded_grads(params, nan_step=4))
    assert_params_close(jparams, tparams, rtol=1e-5, atol=1e-7)
    assert float(ts.total_notfinite) == float(js.total_notfinite) == 1.0
    assert int(ts.inner_state.count) == STEPS - 1


def test_adafactor_matches_transformers_oracle():
    """``tests/test_adafactor.py``'s oracle: relative step, parameter
    scale, clip threshold 1, decay -0.8, eps (1e-30, 1e-3)."""
    from transformers.optimization import Adafactor

    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 0.5, (8, 16)).astype(np.float32)
    b0 = rng.normal(0, 0.5, (16,)).astype(np.float32)
    gw = [rng.normal(0, 0.1, w0.shape).astype(np.float32) for _ in range(STEPS)]
    gb = [rng.normal(0, 0.1, b0.shape).astype(np.float32) for _ in range(STEPS)]
    tw, tb = torch.nn.Parameter(torch.tensor(w0)), torch.nn.Parameter(torch.tensor(b0))
    opt = Adafactor([tw, tb], lr=None, relative_step=True, scale_parameter=True,
                    warmup_init=False)
    for i in range(STEPS):
        opt.zero_grad()
        tw.grad, tb.grad = torch.tensor(gw[i]), torch.tensor(gb[i])
        opt.step()
    params = {"w": torch.tensor(w0), "b": torch.tensor(b0)}
    tx = toptim.adafactor()
    state = tx.init(params)
    for i in range(STEPS):
        updates, state = tx.update({"w": torch.tensor(gw[i]), "b": torch.tensor(gb[i])},
                                   state, params)
        toptim.apply_updates(params, updates)
    np.testing.assert_allclose(params["w"].numpy(), tw.detach().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(params["b"].numpy(), tb.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_adafactor_freeze_mask():
    params = {"a": torch.ones(4, 4), "b": torch.ones(4)}
    tx = toptim.adafactor(freeze={"a": True, "b": False})
    updates, state = tx.update({"a": torch.full((4, 4), 0.1), "b": torch.full((4,), 0.1)},
                               tx.init(params), params)
    assert updates["a"].abs().max() > 0 and updates["b"] is None
    assert state.v_row["b"] is None and state.v["b"] is None


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_grouped_matches_jax_chain(clip):
    """The chain with its in-chain clip, the decay groups and the freeze
    against JAX's ``adamw_grouped`` (rtol 2e-6 / atol 5e-7, the fused
    optimizer's bound in ``test_torch_optim.py``: XLA's f32 pow)."""
    params = small_tree(2)
    freeze = joptim.trainable_mask(params, train_audio_encoder=True, train_lm_decoder=False)
    draws = seeded_grads(params, seed=5)
    grads_of = (lambda s: jax.tree.map(lambda g: g * 100.0, draws(s))) if clip else draws
    jparams, tparams, js, ts = run_both(
        joptim.adamw_grouped(jsched(1e-2, 2, 12), params, grad_clip_norm=clip, freeze=freeze),
        toptim.adamw_grouped(tsched(1e-2, 2, 12), to_torch(params), grad_clip_norm=clip,
                             freeze=to_torch_mask(freeze)),
        params, grads_of, freeze)
    assert_params_close(jparams, tparams, rtol=2e-6, atol=5e-7)
    assert int(ts.count) == STEPS and ts.mu["lm_decoder"]["kernel"] is None


def to_torch_mask(mask):
    return toptim.tree_map(bool, jax.tree.map(bool, mask))


@pytest.mark.parametrize("clip", [None, 0.5])
def test_guarded_chain_equals_fused(clip):
    """``guard_nonfinite(adamw_grouped(...), clip_norm)`` step for step
    equal to ``fused_guarded_adamw`` (``tests/test_training.py:76``):
    finite, clipped, non-finite and frozen leaves, bit for bit here (one
    package, the same expressions)."""
    params = to_torch(small_tree(4))
    freeze = toptim.trainable_mask(params, train_audio_encoder=True, train_lm_decoder=False)
    lr = tsched(1e-2, 2, 10)
    chain = toptim.guard_nonfinite(toptim.adamw_grouped(lr, params, freeze=freeze),
                                   clip_norm=clip)
    fused = toptim.fused_guarded_adamw(lr, params, clip_norm=clip, freeze=freeze)
    p_chain, p_fused = toptim.tree_map(torch.clone, params), toptim.tree_map(torch.clone, params)
    s_chain, s_fused = chain.init(p_chain), fused.init(p_fused)
    rng = np.random.default_rng(3)
    for step in range(6):
        grads = toptim.tree_map(
            lambda p, t: torch.from_numpy(rng.normal(0, 1, tuple(p.shape)).astype(np.float32))
            if t else None, params, freeze)
        if step == 2:
            grads["adapter"]["bias"][0] = float("nan")
        elif step == 4:
            grads = toptim.tree_map(lambda g: None if g is None else g * 100.0, grads)
        u_chain, s_chain = chain.update(grads, s_chain, p_chain)
        u_fused, s_fused = fused.update(grads, s_fused, p_fused)
        toptim.apply_updates(p_chain, u_chain)
        toptim.apply_updates(p_fused, u_fused)
        for a, b in zip(toptim.tree_leaves(p_chain), toptim.tree_leaves(p_fused)):
            assert torch.equal(a, b), step
    assert float(s_chain.total_notfinite) == float(s_fused.total_notfinite) == 1.0
    assert int(s_chain.inner_state.count) == int(s_fused.count) == 5
    for name in ("mu", "nu"):
        for a, b in zip(toptim.tree_leaves(getattr(s_chain.inner_state, name)),
                        toptim.tree_leaves(getattr(s_fused, name))):
            assert (a is None and b is None) or torch.equal(a, b)


def test_guard_folded_clip_matches_in_chain_clip():
    """``guard_nonfinite(clip_norm=c)`` equals the chain's own clip
    (``tests/test_training.py:305``), and a non-finite step leaves the
    inner state untouched and counts."""
    params = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4) / 10,
              "b": torch.ones(5)}
    for scale in (1.0, 100.0):
        grads = toptim.tree_map(lambda p: (p + 0.3) * scale, params)
        folded = toptim.guard_nonfinite(toptim.adamw_grouped(1e-2, params), clip_norm=0.5)
        chained = toptim.adamw_grouped(1e-2, params, grad_clip_norm=0.5)
        u1, _ = folded.update(grads, folded.init(params), params)
        u2, _ = chained.update(grads, chained.init(params), params)
        for a, b in zip(toptim.tree_leaves(u1), toptim.tree_leaves(u2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    folded = toptim.guard_nonfinite(toptim.adamw_grouped(1e-2, params), clip_norm=0.5)
    st = folded.init(params)
    bad = toptim.tree_map(lambda p: p * float("nan"), params)
    u, st2 = folded.update(bad, st, params)
    assert all(torch.all(x == 0) for x in toptim.tree_leaves(u))
    assert float(st2.total_notfinite) == 1.0
    for a, b in zip(toptim.tree_leaves(st.inner_state), toptim.tree_leaves(st2.inner_state)):
        assert torch.equal(a, b)


def test_merge_matching_state_carries_matching_leaves():
    """The JAX ``merge_matching_state`` rule on the port's states: leaves
    of the same path, shape and dtype carry over (moments and the count),
    new leaves (the unfrozen LM) stay fresh."""
    params = to_torch(small_tree(6))
    frozen = toptim.trainable_mask(params, train_audio_encoder=True, train_lm_decoder=False)
    old_tx = toptim.fused_guarded_adamw(1e-2, params, freeze=frozen)
    old = old_tx.init(params)
    grads = toptim.tree_map(lambda p, t: torch.ones_like(p) if t else None, params, frozen)
    for _ in range(2):
        _, old = old_tx.update(grads, old, params)
    unfrozen = toptim.trainable_mask(params, train_audio_encoder=True, train_lm_decoder=True)
    fresh = toptim.fused_guarded_adamw(1e-2, params, freeze=unfrozen).init(params)
    merged = toptim.merge_matching_state(old, fresh)
    assert merged.count is old.count and int(merged.count) == 2
    assert merged.mu["adapter"]["kernel"] is old.mu["adapter"]["kernel"]
    assert torch.equal(merged.mu["lm_decoder"]["kernel"], torch.zeros(4, 4))
    # a leaf whose shape changed is not carried
    other = toptim.FusedGuardedAdamWState(fresh.count, {**fresh.mu, "adapter": {
        **fresh.mu["adapter"], "kernel": torch.zeros(2, 2)}}, fresh.nu, fresh.total_notfinite)
    assert toptim.merge_matching_state(old, other).mu["adapter"]["kernel"].shape == (2, 2)
