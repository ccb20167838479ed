"""Checkpoints of the optimizer states ported after the fused AdamW:
``optimizer.pt`` is one flat dotted-path map of whatever state the
trainer's optimizer has. Six steps equal three, a save, a restore into a
fresh trainer and three more, bit for bit (dropout and LayerDrop on), for
the guarded and unguarded Adafactor (factored ``v_row`` / ``v_col``, 1-D
``v``, its count), the unfused AdamW chain, and a run whose LM was
unfrozen (the fresh trainer unfreezes before restoring, as the train
command line does). And ``utils/port.checkpoint_from_jax`` converts a JAX
orbax checkpoint of Adafactor or of the unfused chain: the restored state
equals the orbax one leaf for leaf (Adafactor's conv-kernel statistics
transposed to the port's layout), and 3 more steps in each package agree
far below one update."""

import os

import numpy as np
import pytest
import torch

from aat_tpu_torch.training import checkpoint as ckpt
from aat_tpu_torch.training import optim as toptim
from aat_tpu_torch.training.trainer import read_checkpoint_meta
from aat_tpu_torch.utils.port import to_jax_params
from tests._torch_trajectories import (assert_trajectories, jax_checkpoint, resumed_losses,
                                       whole_batch)
from tests._torch_threads import two_threads  # noqa: F401
from tests.test_torch_checkpoint import batches, make_trainer

CASES = {
    "adafactor": dict(optimizer="adafactor", learning_rate=None),
    "adafactor-unguarded": dict(optimizer="adafactor", learning_rate=None,
                                skip_nonfinite_updates=False),
    "adamw-unfused": dict(skip_nonfinite_updates=False, grad_clip_norm=0.5),
    "adamw-unfrozen": dict(),
}


def full_state(t) -> dict:
    out = {f"params.{k}": v for k, v in ckpt.flatten(t.state.params).items()}
    out.update({f"opt.{k}": v for k, v in ckpt.flatten(t.state.opt_state).items()})
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_with_each_optimizer_state_is_bitwise(tmp_path, case):
    kw = CASES[case]
    data = batches(400, 6)
    a = make_trainer(tmp_path, "a", dropout=True, **kw)
    if case == "adamw-unfrozen":
        a.unfreeze_lm_decoder()
    for b in data[:3]:
        a.training_step([b], fetch_metrics=False)
    path = a.save_checkpoint()
    saved = torch.load(os.path.join(path, "optimizer.pt"), weights_only=True)
    assert set(saved) == set(ckpt.flatten(a.state.opt_state))
    if case.startswith("adafactor"):
        assert any(".v_row." in f".{k}" for k in saved) and any(".v." in f".{k}" for k in saved)
    for b in data[3:]:
        a.training_step([b], fetch_metrics=False)

    fresh = make_trainer(tmp_path, "b", dropout=True, seed=3, **kw)
    if read_checkpoint_meta(path)["train_lm_decoder"]:
        fresh.unfreeze_lm_decoder()
    fresh.restore_checkpoint(path)
    for b in data[3:]:
        fresh.training_step([b], fetch_metrics=False)
    want, got = full_state(a), full_state(fresh)
    assert set(got) == set(want) and fresh.state.step == a.state.step == 6
    for name, x in want.items():
        assert x.dtype == got[name].dtype and torch.equal(x, got[name]), name


def test_restore_into_another_optimizer_reinitializes(tmp_path, caplog):
    """An Adafactor checkpoint read by an AdamW trainer: the params
    restore, the optimizer state re-initializes (with the warning)."""
    a = make_trainer(tmp_path, "a", **CASES["adafactor"])
    a.training_step([batches(5, 1)[0]], fetch_metrics=False)
    path = a.save_checkpoint()
    b = make_trainer(tmp_path, "b", seed=2)
    b.restore_checkpoint(path)
    assert "not restorable" in caplog.text
    assert int(b.state.opt_state.count) == 0 and b.state.step == 1
    for k, v in ckpt.flatten(a.state.params).items():
        assert torch.equal(v, ckpt.flatten(b.state.params)[k]), k


def state_leaves(tree, path=()):
    """{path: numpy leaf} of a JAX or port optimizer state (NamedTuples by
    field name; MaskedNode, empty states and None skipped)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {path: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(state_leaves(v, path + (k,)))
    return out


@pytest.mark.parametrize("case", ["adafactor", "adamw-unfused"])
def test_jax_checkpoint_of_each_optimizer_converts_and_resumes(tmp_path, case):
    ref, ppath = jax_checkpoint(whole_batch, tmp_path, seed=500, **CASES[case])
    state = ref.saved

    t = make_trainer(tmp_path, "port", seed=4, **CASES[case])
    t.restore_checkpoint(ppath)
    opt = t.state.opt_state
    assert t.state.step == 3 and isinstance(opt, toptim.GuardNonfiniteState if case == "adafactor"
                                            else toptim.ScaleByAdamState)
    inner = opt.inner_state if case == "adafactor" else opt
    assert int(inner.count) == 3
    # every moment of a leaf whose layout is the same equals the orbax one
    jleaves = state_leaves(state["opt_state"])
    names = ("v_row", "v_col", "v") if case == "adafactor" else ("mu", "nu")
    compared = 0
    for name in names:
        for path, got in state_leaves(getattr(inner, name)).items():
            if path[:2] in (("audio_encoder", "feature_extractor"), ("audio_encoder", "pos_conv")):
                continue  # conv kernels: the port's layout, checked by the steps below
            want = [v for k, v in jleaves.items() if k[-len(path) - 1:] == (name,) + path]
            assert len(want) == 1, (name, path)
            np.testing.assert_array_equal(got, want[0], err_msg=f"{name}{path}")
            compared += 1
    assert compared > 20

    losses = resumed_losses(ref, t, whole_batch, 500)
    assert t.state.step == ref.step == 6
    # a step moves a parameter by about 1e-4 (AdamW) to 2e-4 (the relative
    # step); read: the losses within 1e-6 and the parameters within one
    # float32 ulp at 1.0, where a conv kernel's statistics transposed
    # wrongly moved the losses by 2.7e-5 and a norm scale by 4e-3. Left
    # out under Adafactor: the attention k biases, whose gradient is zero
    # but for rounding (the softmax ignores a per-query constant), and
    # which Adafactor's RMS-normalized update turns into full-size noise
    for step, (lj, lt) in enumerate(losses):
        assert abs(lj - lt) <= 1e-6, (step, lj, lt)
    jparams, tparams = ref.params[-1], to_jax_params(t.state.params)
    if case == "adafactor":
        for tree in (jparams, tparams):
            for layer in tree["audio_encoder"]["layers"]:
                layer["attention"]["k"].pop("bias")
    assert_trajectories([], jparams, tparams, 1.2e-7)
