"""Port optimizer pieces vs the JAX package: ``fused_guarded_adamw`` over
steps with a non-finite step, clipping, the freeze mask and the decay
mask; ``warmup_linear_schedule``; ``caption_cross_entropy``; the decay and
freeze masks on a full ASLM tree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aat_tpu.training import optim as joptim
from aat_tpu.training.lr_schedule import warmup_linear_schedule as jsched
from aat_tpu.training.trainer import caption_cross_entropy as jce
from aat_tpu_torch.training import optim as toptim
from aat_tpu_torch.training.lr_schedule import warmup_linear_schedule as tsched
from aat_tpu_torch.training.trainer import caption_cross_entropy as tce
from aat_tpu_torch.utils.port import from_jax_params
from test_torch_port import jax_int_seed_params, tiny_configs


def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "audio_encoder": {"layers": [{"kernel": rng.normal(0, 1, (8, 8)).astype(np.float32),
                                      "layer_norm": {"scale": np.ones(8, np.float32)}}]},
        "adapter": {"kernel": rng.normal(0, 1, (8, 4)).astype(np.float32),
                    "bias": rng.normal(0, 1, (4,)).astype(np.float32),
                    "norm": {"scale": np.ones((4,), np.float32)}},
        "lm_decoder": {"kernel": np.ones((4, 4), np.float32)},
    }


@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_guarded_adamw_matches_jax(clip):
    params = small_tree()
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = toptim.tree_map(torch.from_numpy, jax.tree.map(np.array, params))
    jfreeze = joptim.trainable_mask(jparams, train_audio_encoder=True, train_lm_decoder=False)
    tfreeze = toptim.trainable_mask(tparams, train_audio_encoder=True, train_lm_decoder=False)
    assert jax.tree.leaves(jfreeze) == toptim.tree_leaves(tfreeze)
    jtx = joptim.fused_guarded_adamw(jsched(1e-2, 2, 10), jparams, weight_decay=0.1,
                                     clip_norm=clip, freeze=jfreeze)
    ttx = toptim.fused_guarded_adamw(tsched(1e-2, 2, 10), tparams, weight_decay=0.1,
                                     clip_norm=clip, freeze=tfreeze)
    js, ts = jtx.init(jparams), ttx.init(tparams)
    rng = np.random.default_rng(3)
    for step in range(5):
        grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        if step == 2:  # a non-finite step drops identically on both
            grads["adapter"]["bias"][1] = np.nan
        elif step == 3:  # a large step: the clip branch when clipping
            grads = jax.tree.map(lambda g: g * 100.0, grads)
        # frozen leaves: exact zeros in JAX (stop_gradient), None in the port
        grads["lm_decoder"]["kernel"][:] = 0.0
        ju, js = jtx.update(jax.tree.map(jnp.asarray, grads), js, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tgrads = toptim.tree_map(lambda g, t: torch.from_numpy(g) if t else None,
                                 grads, tfreeze)
        tu, ts = ttx.update(tgrads, ts, tparams)
        toptim.apply_updates(tparams, tu)
        # XLA's f32 pow on the CPU can be an ulp off the correctly rounded
        # b2**n that torch.pow gives; 1 - b2**n (b2 = 0.999) cancels three
        # digits, so an update may differ by ~1e-5 of its size
        for a, b in zip(jax.tree.leaves(jparams), toptim.tree_leaves(tparams)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6, atol=5e-7,
                                       err_msg=f"step {step}")
    assert int(ts.count) == int(js.count) == 4
    assert float(ts.total_notfinite) == float(js.total_notfinite) == 1.0
    # frozen leaves carry no state and stay bit-identical
    assert ts.mu["lm_decoder"]["kernel"] is None and ts.nu["lm_decoder"]["kernel"] is None
    np.testing.assert_array_equal(tparams["lm_decoder"]["kernel"].numpy(), 1.0)


def test_warmup_linear_schedule_matches_jax():
    j, t = jsched(1e-4, 10, 100, 1e-5), tsched(1e-4, 10, 100, 1e-5)
    for step in [0, 1, 5, 9, 10, 50, 99, 100, 150]:
        assert float(t(step)) == float(j(step)), step
    assert float(t(torch.tensor(7, dtype=torch.int32))) == float(j(7))


@pytest.mark.parametrize("presliced", [False, True])
def test_caption_cross_entropy_matches_jax(presliced):
    rng = np.random.default_rng(5)
    b, t, c, v = 3, 14, 6, 37
    logits = rng.normal(0, 2, (b, c - 1 if presliced else t, v)).astype(np.float32)
    ids = rng.integers(0, v, (b, c))
    mask = np.ones((b, c), np.int32)
    mask[1, 3:] = 0
    mask[2, :] = 0  # an all-pad caption contributes nothing
    want = float(jce(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask)))
    got = float(tce(torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * abs(want)


def by_path(tree) -> dict:
    """{path: leaf} of a tree of dicts and lists (JAX's or the port's)."""
    return dict(zip(toptim.tree_leaves(toptim.tree_paths(tree)), toptim.tree_leaves(tree)))


def test_masks_and_global_norm_match_jax_on_aslm_tree():
    jmodel, _ = tiny_configs()
    jtree = jax_int_seed_params(jmodel)
    ttree = from_jax_params(jax.device_get(jtree))
    # conv kernels are permuted in the port's layout; their ndim is the same
    want = by_path(joptim.decay_mask(jtree))
    assert by_path(toptim.decay_mask(ttree)) == want
    assert want["audio_encoder/layers/0/attention/q/kernel"]
    assert not want["audio_encoder/layers/0/layer_norm/scale"]
    for flags in [(True, False), (False, True)]:
        want = by_path(joptim.trainable_mask(jtree, *flags))
        assert by_path(toptim.trainable_mask(ttree, *flags)) == want
    want = float(joptim.global_norm(jtree))
    got = float(toptim.global_norm(ttree))
    assert abs(got - want) <= 1e-6 * want
    # a None leaf (a LayerDrop-skipped gradient) counts as zero
    assert float(toptim.global_norm({"a": None, "b": torch.tensor([3.0, 4.0])})) == 5.0
