"""Port ``AATTrainer`` vs the JAX package's at tiny widths: 3 optimizer
steps on whole-utterance batches, at gradient accumulation 1 and 2, f32
compute, the port on its flash route (its gate forced down; on the CPU the
kernels' plain versions) and JAX on its XLA attention
(``tests/_torch_trajectories.py``). The LM is frozen, as in the default
training config, so its causal flash backward carries the encoder's
gradient. Dropout and LayerDrop are off in the parity runs (the two
packages cannot draw the same masks); a port-only test holds train-mode
dropout to determinism. The segmented and bf16 runs are in their own
files, so the test workers take them in parallel."""

import os

import numpy as np
import pytest
import torch

import jax

from aat_tpu_torch.data.ondevice import segment_raw_batch
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.trainer import AATTrainer as TTrainer
from aat_tpu_torch.training.trainer import AATTrainerSegmentation, read_checkpoint_meta
from aat_tpu_torch.utils.port import to_jax_params
from tests._torch_trajectories import (TRAIN, assert_trajectories, flash_route, jax_params,
                                       jax_reference, models, port_model, raw_batch, run_both,
                                       whole_batch)
from tests import _torch_trajectories as trajectories
from tests._torch_threads import two_threads  # noqa: F401


@pytest.mark.parametrize("accum", [1, 2])
def test_whole_utterance_trajectory_matches_jax(monkeypatch, accum):
    flash_route(monkeypatch)
    r = run_both(whole_batch, accum=accum, seed=accum)
    (jparams, tparams), mj, mt = r.params[-1], r.mj, r.mt
    assert_trajectories(r.losses, jparams, tparams, 2e-4)
    for k in ("train/audio_encdoer_grad_norm", "train/audio_tokens_emb_grad",
              "debug/audio_embeddings_norm_mean", "debug/text_embeddings_mean"):
        assert abs(mt[k] - mj[k]) <= 1e-4 * max(1.0, abs(mj[k])), k
    # the frozen LM did not move: bit for bit its initial weights
    init = jax.device_get(jax_params(models()[0]))["lm_decoder"]
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(tparams["lm_decoder"])):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_placed_optimizer_state_leaves_the_jax_reference_bit_for_bit(monkeypatch):
    """The harness replicates the JAX trainer's unplaced optimizer-state
    leaves (``_place_opt_state``) to compile its step once: the first
    step's metrics and parameters equal those of the trainer left as it
    places them. Every later step runs the same program in both, since the
    step's outputs carry the mesh's sharding."""
    placed = jax_reference(whole_batch, steps=1)
    monkeypatch.setattr(trajectories, "_place_opt_state", lambda jt: None)
    unplaced = jax_reference(whole_batch, steps=1)
    assert placed.metrics == unplaced.metrics and placed.step == unplaced.step
    for a, b in zip(jax.tree.leaves(placed.params), jax.tree.leaves(unplaced.params)):
        np.testing.assert_array_equal(a, b)


def dropout_run(seed, rates):
    tm, params = port_model(**rates)
    t = AATTrainerSegmentation(tm, params, TConfig(**TRAIN, gradient_accumulation_steps=1,
                                                   seed=seed))
    rng = np.random.default_rng(0)
    losses = [t.training_step([whole_batch(rng)])["train/loss"] for _ in range(2)]
    return losses, to_jax_params(t.state.params)


def test_train_mode_dropout_is_deterministic():
    """Seeds derive from (config.seed, step, microbatch) alone: two runs are
    equal, and they differ from a dropout-off run and from another seed."""
    on = dict(hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
              feature_projection_dropout=0.1, layerdrop=0.1)
    a, pa = dropout_run(42, on)
    b, pb = dropout_run(42, on)
    off, _ = dropout_run(42, {})
    other, _ = dropout_run(7, on)
    assert a == b
    for x, y in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_array_equal(x, y)
    assert a[0] != off[0] and a[0] != other[0]
    assert all(np.isfinite(a))


def test_unported_options_raise():
    """Every multi-device option is ported: pp, and Adafactor under fsdp or
    tp, reach the mesh (which needs a process group); sp with pp is refused
    as JAX refuses it, and so is a pp that does not divide a stack's
    layers; a mesh must cover the process group exactly."""
    import torch.distributed as dist

    from aat_tpu_torch.parallel.distributed import free_port

    tm, params = port_model()
    TConfig(**dict(TRAIN, mesh_dp=2, mesh_fsdp=2, mesh_tp=2, mesh_sp=2))  # no longer refused
    with pytest.raises(ValueError, match="mutually exclusive"):
        TTrainer(tm, params, TConfig(**dict(TRAIN, mesh_sp=2, mesh_pp=2)))
    # the tiny stacks have 2 layers: pp 4 does not divide them
    with pytest.raises(ValueError, match="num_hidden_layers=2 is not divisible by mesh_pp=4"):
        TTrainer(tm, params, TConfig(**dict(TRAIN, mesh_pp=4)))
    for kw in (dict(mesh_pp=2), dict(optimizer="adafactor", learning_rate=None, mesh_fsdp=2),
               dict(optimizer="adafactor", learning_rate=None, mesh_tp=2)):
        with pytest.raises(RuntimeError, match="initialized process group"):
            TTrainer(tm, params, TConfig(**dict(TRAIN, **kw)))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for axis in ("mesh_dp", "mesh_pp"):
            with pytest.raises(ValueError, match="2 ranks, the process group 1"):
                TTrainer(tm, params, TConfig(**dict(TRAIN, **{axis: 2})))
    finally:
        dist.destroy_process_group()


def test_raw_waveform_batch_equals_presegmented():
    """``raw_waveforms`` batches segment on the device inside the step
    (uniform segmentation here); the loss equals that of the same batch
    segmented beforehand by ``segment_raw_batch``."""
    batch = raw_batch(np.random.default_rng(4))
    cfg = TConfig(**TRAIN, gradient_accumulation_steps=1, segmentation="uniform",
                  max_segment_frames=400, max_on_device_segments=5)
    losses = []
    for presegment in (False, True):
        tm, params = port_model()
        t = AATTrainerSegmentation(tm, params, cfg)
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        if presegment:
            b = segment_raw_batch(b, segmentation="uniform", max_segment_frames=400,
                                  max_segments=5, sampling_rate=16000)
            del b["raw_waveforms"]
            assert b["batched_segments"].shape == (2, 5, 400)
        losses.append(t.training_step([b])["train/loss"])
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_train_epoch_logs_and_stops_at_max_steps():
    """``train``: a step per ``gradient_accumulation_steps`` microbatches,
    logs every ``logging_steps`` with the lr and step time, stops at
    ``max_steps``."""
    tm, params = port_model()
    logged = []
    cfg = TConfig(**dict(TRAIN, logging_steps=1, max_steps=2), gradient_accumulation_steps=2)
    t = TTrainer(tm, params, cfg, log_fn=logged.append)
    rng = np.random.default_rng(6)
    state = t.train([whole_batch(rng) for _ in range(7)])
    assert state.step == 2 and len(logged) == 2
    assert logged[1]["train/lr"] == float(t.schedule(2))
    assert all(np.isfinite(m["train/loss"]) and m["train/step_time"] > 0 for m in logged)


@pytest.mark.parametrize("save_steps, max_steps", [(2, 2), (5, None), (1000, 3), (0, 2)])
def test_train_writes_checkpoints_at_save_steps(tmp_path, save_steps, max_steps):
    """``train`` writes ``checkpoint-{step}``, with ``trainer_meta.json``
    beside it, exactly at the multiples of ``save_steps`` reached before
    ``max_steps`` or the end of the batches (3 here); ``save_steps=0``
    writes none."""
    tm, params = port_model()
    t = TTrainer(tm, params, TConfig(**dict(TRAIN, save_steps=save_steps, max_steps=max_steps,
                                            output_dir=str(tmp_path)),
                                     gradient_accumulation_steps=1))
    rng = np.random.default_rng(7)
    state = t.train([whole_batch(rng) for _ in range(3)])
    last = max_steps or 3
    assert state.step == last
    want = [f"checkpoint-{s}" for s in range(1, last + 1) if save_steps and s % save_steps == 0]
    assert sorted(os.listdir(tmp_path)) == want
    for name in want:
        assert sorted(os.listdir(tmp_path / name)) == ["optimizer.pt", "params.pt",
                                                         "trainer_meta.json"]
        assert read_checkpoint_meta(str(tmp_path / name))["step"] == int(name.split("-")[1])
