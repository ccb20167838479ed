"""Port ``AATTrainer`` vs the JAX package's at tiny widths: 3 optimizer
steps on whole-utterance batches, at gradient accumulation 1 and 2, f32
compute, with both attention gates forced down so both packages
take the flash route (JAX Pallas in interpret mode, the port's kernel
plain versions on the CPU). The LM is frozen, as in the default training
config, so its causal flash backward carries the encoder's gradient.
Dropout and LayerDrop are off in the parity runs (the two packages cannot
draw the same masks); a port-only test holds train-mode dropout to
determinism. The segmented and bf16 runs are in their own files, so the
test workers take them in parallel."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt
from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu.training.trainer import AATTrainer as JTrainer
from aat_tpu_torch.data.ondevice import segment_raw_batch
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.trainer import AATTrainer as TTrainer
from aat_tpu_torch.training.trainer import AATTrainerSegmentation, read_checkpoint_meta
from aat_tpu_torch.utils.port import from_jax_params, to_jax_params

ASLM = dict(projection_type="linear", audio_encoder_hidden=32, lm_hidden=32,
            projection_hidden=48)
TRAIN = dict(learning_rate=1e-4, warmup_steps=2, max_steps=10, compute_dtype="float32",
             logging_steps=1000, eval_steps=0, save_steps=0)


def models(**hubert_kw):
    """(JAX model, port model): tiny HuBERT and Llama on the flash route."""
    jm = jaslm.AslmModel(
        jaslm.AslmConfig(**ASLM),
        dataclasses.replace(jhub.tiny_test_config(), attention_impl="pallas", **hubert_kw),
        dataclasses.replace(jllm.tiny_test_config(), attention_impl="pallas"))
    tm = taslm.AslmModel(
        taslm.AslmConfig(**ASLM),
        dataclasses.replace(thub.tiny_test_config(), attention_impl="pallas", **hubert_kw),
        dataclasses.replace(tllm.tiny_test_config(), attention_impl="pallas"))
    return jm, tm


def jax_params(jm, seed=0):
    return {"audio_encoder": jhub.init_hubert_params(seed, jm.audio_encoder_config),
            "adapter": jaslm.init_aslm_params(seed + 1, jm.config),
            "lm_decoder": jllm.init_llama_params(seed + 2, jm.lm_config)}


def captions(rng, b, c=6, vocab=100):
    ids = rng.integers(1, vocab, (b, c))
    mask = np.ones((b, c), np.int32)
    mask[-1, c - 2:] = 0
    return {"input_ids": ids, "attention_mask": mask, "input_ids_attention_mask": mask}


def whole_batch(rng, b=2, length=480):
    """Whole utterances of 480 samples (23 frames at the tiny conv stack),
    the last one padded."""
    mask = np.ones((b, length), np.int32)
    mask[-1, 400:] = 0
    return {"waveforms": rng.normal(0, 0.3, (b, length)).astype(np.float32),
            "waveforms_attention_mask": mask, **captions(rng, b)}


def segmented_batch(rng, b=2, n_seg=3, frames=240):
    wmask = np.ones((b, n_seg, frames), np.int32)
    wmask[1, 1, 200:] = 0
    smask = np.ones((b, n_seg), np.int32)
    smask[1, 2] = 0  # a padded segment
    return {"batched_segments": rng.normal(0, 0.3, (b, n_seg, frames)).astype(np.float32),
            "segments_waveforms_mask": wmask, "segments_boarders_attention_mask": smask,
            **captions(rng, b)}


def run_both(monkeypatch, make_batch, accum, steps=3, trainer_cls=TTrainer, **train_kw):
    """Per-step losses and final parameters of both trainers on the same
    seeded batches and weights."""
    monkeypatch.setattr(jatt, "MIN_PALLAS_SEQ_LEN", 1)
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    jm, tm = models()
    jp = jax_params(jm)
    kw = dict(TRAIN, gradient_accumulation_steps=accum, **train_kw)
    jt = JTrainer(jm, jp, JConfig(**kw))
    tt = trainer_cls(tm, from_jax_params(jax.device_get(jp)), TConfig(**kw))
    rng = np.random.default_rng(accum)
    losses = []
    for _ in range(steps):
        micro = [make_batch(rng) for _ in range(accum)]
        mj, mt = jt.training_step(micro), tt.training_step(micro)
        losses.append((mj["train/loss"], mt["train/loss"]))
        assert set(mt) == set(mj)
    return losses, jax.device_get(jt.state.params), to_jax_params(tt.state.params), mj, mt


def assert_trajectories(losses, jparams, tparams, tol):
    for step, (lj, lt) in enumerate(losses):
        assert abs(lj - lt) <= tol, (step, lj, lt)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = jax.tree.leaves(tparams)
    for (path, a), b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, np.asarray(a), atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("accum", [1, 2])
def test_whole_utterance_trajectory_matches_jax(monkeypatch, accum):
    losses, jparams, tparams, mj, mt = run_both(monkeypatch, whole_batch, accum)
    assert_trajectories(losses, jparams, tparams, 2e-4)
    for k in ("train/audio_encdoer_grad_norm", "train/audio_tokens_emb_grad",
              "debug/audio_embeddings_norm_mean", "debug/text_embeddings_mean"):
        assert abs(mt[k] - mj[k]) <= 1e-4 * max(1.0, abs(mj[k])), k
    # the frozen LM did not move: bit for bit its initial weights
    init = jax.device_get(jax_params(models()[0]))["lm_decoder"]
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(tparams["lm_decoder"])):
        np.testing.assert_array_equal(b, np.asarray(a))


def dropout_run(seed, rates):
    _, tm = models(**rates)
    jm, _ = models()
    params = from_jax_params(jax.device_get(jax_params(jm)))
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
    """Multi-device training is ported but for the pipeline axis and
    Adafactor under fsdp / tp (ROADMAP item 8b); sp with pp is refused as
    JAX refuses it; a mesh must cover the process group exactly."""
    import torch.distributed as dist

    from aat_tpu_torch.parallel.distributed import free_port

    _, tm = models()
    jm, _ = models()
    params = from_jax_params(jax.device_get(jax_params(jm)))
    TConfig(**dict(TRAIN, mesh_dp=2, mesh_fsdp=2, mesh_tp=2, mesh_sp=2))  # no longer refused
    with pytest.raises(ValueError, match="mutually exclusive"):
        TTrainer(tm, params, TConfig(**dict(TRAIN, mesh_sp=2, mesh_pp=2)))
    with pytest.raises(NotImplementedError, match="item 8b"):
        TTrainer(tm, params, TConfig(**dict(TRAIN, mesh_pp=2)))
    for axis in ("mesh_fsdp", "mesh_tp"):
        with pytest.raises(NotImplementedError, match="item 8b"):
            TTrainer(tm, params, TConfig(**dict(TRAIN, optimizer="adafactor",
                                                learning_rate=None, **{axis: 2})))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="2 ranks, the process group 1"):
            TTrainer(tm, params, TConfig(**dict(TRAIN, mesh_dp=2)))
    finally:
        dist.destroy_process_group()


def test_raw_waveform_batch_equals_presegmented():
    """``raw_waveforms`` batches segment on the device inside the step
    (uniform segmentation here); the loss equals that of the same batch
    segmented beforehand by ``segment_raw_batch``."""
    jm, tm = models()
    rng = np.random.default_rng(4)
    raw = rng.normal(0, 0.3, (2, 1600)).astype(np.float32)
    lengths = np.array([1600, 1100])
    raw[1, 1100:] = 0.0
    batch = {"raw_waveforms": raw, "raw_lengths": lengths, **captions(rng, 2)}
    cfg = TConfig(**TRAIN, gradient_accumulation_steps=1, segmentation="uniform",
                  max_segment_frames=400, max_on_device_segments=5)
    losses = []
    for presegment in (False, True):
        params = from_jax_params(jax.device_get(jax_params(jm)))
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
    jm, tm = models()
    params = from_jax_params(jax.device_get(jax_params(jm)))
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
    jm, tm = models()
    params = from_jax_params(jax.device_get(jax_params(jm)))
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
