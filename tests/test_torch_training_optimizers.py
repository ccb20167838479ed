"""The port's ``AATTrainer`` against the JAX package's over 3 steps at tiny
widths (the port on its flash route, JAX on its XLA attention, f32,
dropout off; ``tests/_torch_trajectories.py``), with the
trainer pieces ported after the fused AdamW: ``optimizer="adafactor"``
with ``learning_rate=None`` (the relative step, under the non-finite
guard), the unfused chain (``skip_nonfinite_updates=False``), and the LM
unfrozen after the first step (``tests/test_unfreeze.py``,
``tests/test_training.py:367``). Losses and parameters within 2e-4, the
trajectory tolerance of ``tests/test_torch_training.py``."""

import jax
import numpy as np
import pytest
import torch

from aat_tpu_torch.training import checkpoint as ckpt
from aat_tpu_torch.training import optim as toptim
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.trainer import AATTrainer as TTrainer
from tests._torch_trajectories import (TRAIN, assert_trajectories, flash_route, jax_params, models,
                                       port_model, run_both, segmented_batch, whole_batch)
from tests._torch_threads import two_threads  # noqa: F401

TOL = 2e-4


def lm_moved(tparams, jm_seed_params):
    init = jm_seed_params["lm_decoder"]
    return any(not np.array_equal(np.asarray(a), b)
               for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(tparams["lm_decoder"])))


def test_adafactor_relative_step_trajectory_matches_jax(monkeypatch):
    flash_route(monkeypatch)
    r = run_both(segmented_batch, seed=7, optimizer="adafactor", learning_rate=None)
    (jparams, tparams), tt = r.params[-1], r.tt
    assert_trajectories(r.losses, jparams, tparams, TOL)
    assert tt.schedule is None and isinstance(tt.state.opt_state, toptim.GuardNonfiniteState)
    assert int(tt.state.opt_state.inner_state.count) == 3
    assert not lm_moved(tparams, jax.device_get(jax_params(models()[0])))


def test_unfused_adamw_trajectory_matches_jax(monkeypatch):
    flash_route(monkeypatch)
    r = run_both(whole_batch, seed=7, skip_nonfinite_updates=False, grad_clip_norm=0.05)
    tt = r.tt
    assert_trajectories(r.losses, *r.params[-1], TOL)
    assert isinstance(tt.state.opt_state, toptim.ScaleByAdamState)
    assert int(tt.state.opt_state.count) == 3


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_unfreeze_mid_run_trajectory_matches_jax(monkeypatch, optimizer):
    """The LM frozen for step 1 (bit for bit), unfrozen for steps 2-3: its
    moments start fresh, the others' carry over, and both packages agree."""
    kw = dict(optimizer="adafactor", learning_rate=None) if optimizer == "adafactor" else {}
    flash_route(monkeypatch)
    r = run_both(whole_batch, seed=7, unfreeze_after=1, **kw)
    (jparams, tparams), tt = r.params[-1], r.tt
    assert_trajectories(r.losses, jparams, tparams, TOL)
    assert tt.config.train_lm_decoder and lm_moved(tparams, jax.device_get(
        jax_params(models()[0])))
    state = ckpt.flatten(tt.state.opt_state)
    assert any(".lm_decoder." in f".{k}" for k in state)


def test_unfreeze_keeps_the_moments_of_what_trained(monkeypatch):
    """``unfreeze_lm_decoder`` after 3 steps: every optimizer-state leaf is
    carried bit for bit (the count too), the LM's moments are new zeros,
    and the forward stops detaching the LM (``tests/test_training.py:367``)."""
    flash_route(monkeypatch)
    tt = TTrainer(*port_model(), TConfig(**dict(TRAIN, gradient_accumulation_steps=1)))
    rng = np.random.default_rng(11)
    for _ in range(3):
        tt.training_step([whole_batch(rng)], fetch_metrics=False)
    old = {k: v.clone() for k, v in ckpt.flatten(tt.state.opt_state).items()}
    lm_before = {k: v.clone() for k, v in ckpt.flatten(tt.state.params["lm_decoder"]).items()}
    tt.unfreeze_lm_decoder()
    new = ckpt.flatten(tt.state.opt_state)
    for k, v in old.items():
        assert torch.equal(new[k], v), k
    added = [k for k in new if k not in old]
    assert added and all(".lm_decoder." in f".{k}" for k in added)
    assert all(float(new[k].abs().max()) == 0.0 for k in added)
    assert all(t for t in toptim.tree_leaves(tt.freeze["lm_decoder"]))
    m = tt.training_step([whole_batch(rng)])
    assert np.isfinite(m["train/loss"])
    assert any(not torch.equal(v, lm_before[k])
               for k, v in ckpt.flatten(tt.state.params["lm_decoder"]).items())

