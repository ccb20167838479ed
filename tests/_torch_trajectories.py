"""The port's trainer held to the JAX package's on the CPU: tiny models,
batch makers, the trajectory check, one runner of both trainers.

The port's models take their flash route (``attention_impl="pallas"``;
``flash_route`` forces its gate to ``T = 1``, where on the CPU the flash
autograd Function runs the kernels' plain versions). The JAX model takes
its XLA attention: JAX's Pallas kernels run in interpret mode on the CPU,
several times slower, to the same numbers (``tests/test_attention.py``).
A test about a JAX kernel route builds its JAX model on ``"pallas"``."""

import dataclasses
import os
import tempfile

import numpy as np

import jax
from jax.sharding import NamedSharding

import aat_tpu_torch.ops.attention as tatt
from aat_tpu.models import aslm as jaslm
from aat_tpu.models import efficientnet as jeff
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.parallel import mesh as jmesh
from aat_tpu.training import trainer as jtrainer
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import efficientnet as teff
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training import trainer as ttrainer
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.utils.port import checkpoint_from_jax, from_jax_params, to_jax_params

ASLM = dict(projection_type="linear", audio_encoder_hidden=32, lm_hidden=32,
            projection_hidden=48)
TRAIN = dict(learning_rate=1e-4, warmup_steps=2, max_steps=10, compute_dtype="float32",
             logging_steps=1000, eval_steps=0, save_steps=0)


def flash_route(monkeypatch):
    """The port's attention gate down to ``T = 1``."""
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)


def models(**hubert_kw):
    """(JAX model, port model): tiny HuBERT and Llama."""
    jm = jaslm.AslmModel(jaslm.AslmConfig(**ASLM),
                         dataclasses.replace(jhub.tiny_test_config(), **hubert_kw),
                         jllm.tiny_test_config())
    tm = taslm.AslmModel(
        taslm.AslmConfig(**ASLM),
        dataclasses.replace(thub.tiny_test_config(), attention_impl="pallas", **hubert_kw),
        dataclasses.replace(tllm.tiny_test_config(), attention_impl="pallas"))
    return jm, tm


def pooling_models(**pool):
    """(JAX model, port model): the tiny HuBERT and Llama joined by the
    ``transformer_encoder`` projection of ``pool``, dropout off."""
    aslm = dict(projection_type="transformer_encoder", audio_encoder_hidden=32, lm_hidden=32,
                dropout=0.0)
    return (jaslm.AslmModel(jaslm.AslmConfig(pooling=jaslm.PoolingConfig(**pool), **aslm),
                            jhub.tiny_test_config(), jllm.tiny_test_config()),
            taslm.AslmModel(taslm.AslmConfig(pooling=taslm.PoolingConfig(**pool), **aslm),
                            thub.tiny_test_config(), tllm.tiny_test_config()))


def efficientnet_models(encoder_seed, **aslm):
    """(JAX model, port model, JAX weights): EfficientNet-b0 and the tiny
    Llama joined by the projection ``aslm``."""
    aslm = dict(audio_encoder_hidden=1280, lm_hidden=32, **aslm)
    jm = jaslm.AslmModel(jaslm.AslmConfig(**aslm), jeff.EfficientNetConfig(),
                         jllm.tiny_test_config(), audio_encoder_type="efficient_net")
    tm = taslm.AslmModel(taslm.AslmConfig(**aslm), teff.EfficientNetConfig(),
                         tllm.tiny_test_config(), audio_encoder_type="efficient_net")
    jp = {"audio_encoder": jeff.init_efficientnet_params(encoder_seed),
          "adapter": jaslm.init_aslm_params(1, jm.config),
          "lm_decoder": jllm.init_llama_params(3, jm.lm_config)}
    return jm, tm, jp


def jax_params(jm, seed=0):
    return {"audio_encoder": jhub.init_hubert_params(seed, jm.audio_encoder_config),
            "adapter": jaslm.init_aslm_params(seed + 1, jm.config),
            "lm_decoder": jllm.init_llama_params(seed + 2, jm.lm_config)}


def port_model(seed=0, **hubert_kw):
    """The tiny port model, and in its layout the JAX package's weights."""
    jm, tm = models(**hubert_kw)
    return tm, port_params(jax_params(jm, seed))


def port_params(jp):
    """The port's tree of ``jp`` on memory of its own: the port trains in
    place, and its tensors would share the numpy arrays' memory."""
    return from_jax_params(jax.tree.map(np.array, jax.device_get(jp)))


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


def raw_batch(rng):
    """Raw waveforms of 1600 samples, the second 1100 long."""
    raw = rng.normal(0, 0.3, (2, 1600)).astype(np.float32)
    raw[1, 1100:] = 0.0
    return {"raw_waveforms": raw, "raw_lengths": np.array([1600, 1100]), **captions(rng, 2)}


def melspec_batch(rng, b=2, s=2):
    smask = np.ones((b, s), np.int32)
    smask[1, 1] = 0  # a padded segment
    return {"batched_segments_melspectrograms": rng.normal(0, 1, (b, s, 64, 26)).astype(
        np.float32), "segments_boarders_attention_mask": smask, **captions(rng, b)}


def assert_trajectories(losses, jparams, tparams, tol, loss_rtol=None):
    """Each step's (JAX, port) losses within ``tol`` (or ``loss_rtol`` of
    JAX's), and every parameter within ``tol``."""
    for step, (lj, lt) in enumerate(losses):
        bar = tol if loss_rtol is None else loss_rtol * abs(lj)
        assert np.isfinite(lt) and abs(lj - lt) <= bar, (step, lj, lt)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = jax.tree.leaves(tparams)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, np.asarray(a), atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@dataclasses.dataclass
class Reference:
    """A JAX trainer's run: each step's metrics and parameters (numpy), and
    with ``save_at`` its orbax state then, in numpy, and checkpoint meta."""

    model: object
    step: int
    metrics: list
    params: list
    saved: dict = None
    saved_meta: dict = None


def jax_reference(make_batch, jm=None, jp=None, *, accum=1, steps=3, seed=0,
                  trainer="AATTrainer", unfreeze_after=None, save_at=None, **train_kw):
    """The JAX ``trainer`` (a class of ``training/trainer.py``) from the
    weights ``jp`` (the tiny pair's by default) over ``steps`` steps of
    ``accum`` batches ``make_batch(rng)``, ``rng`` from ``seed``; with
    ``unfreeze_after`` it unfreezes the LM after that many steps, and with
    ``save_at`` it saves its checkpoint after that many."""
    jm = models()[0] if jm is None else jm
    jp = jax_params(jm) if jp is None else jp
    with tempfile.TemporaryDirectory() as out:
        jt = getattr(jtrainer, trainer)(jm, jax.tree.map(np.array, jax.device_get(jp)), JConfig(
            **dict(TRAIN, gradient_accumulation_steps=accum, output_dir=out, **train_kw)))
        _place_opt_state(jt)
        rng = np.random.default_rng(seed)
        ref = Reference(model=jm, step=0, metrics=[], params=[])
        for step in range(steps):
            if step == unfreeze_after:
                jt.unfreeze_lm_decoder()
                _place_opt_state(jt)
            ref.metrics.append(jt.training_step([make_batch(rng) for _ in range(accum)]))
            ref.params.append(jax.tree.map(np.array, jax.device_get(jt.state.params)))
            if step + 1 == save_at:
                ref.saved, ref.saved_meta = _saved_state(jt)
        ref.step = jt.state.step
    return ref


def _place_opt_state(jt):
    """Replicate on the trainer's mesh the optimizer-state leaves that
    ``tx.init`` leaves unplaced (the step counters), as the step's outputs
    are: the first step then runs the program every later step runs, traced
    and compiled once instead of twice. No value changes: the references
    came out bit for bit those of the unplaced state at whole-utterance
    accumulation 1 and 2, segmented Adafactor, unfrozen Adafactor, unfused
    AdamW, bf16, a 6-step run with its checkpoint, EfficientNet at
    accumulation 2 and pooling on raw waveforms; ``test_torch_training.py``
    keeps that check on the first step of the default run."""
    rep = jmesh.replicated(jt.mesh)
    jt.state = dataclasses.replace(jt.state, opt_state=jax.tree.map(
        lambda x: x if isinstance(getattr(x, "sharding", None), NamedSharding)
        else jax.device_put(x, rep), jt.state.opt_state))


def _saved_state(jt):
    """The trainer's orbax checkpoint, restored to numpy, and its meta."""
    import orbax.checkpoint as ocp

    path = jt.save_checkpoint()
    template = {"params": jt.state.params, "opt_state": jt.state.opt_state,
                "step": jt.state.step}
    state = jax.device_get(ocp.StandardCheckpointer().restore(
        os.path.join(path, "state"), target=template))
    return state, jtrainer.read_checkpoint_meta(path)


def jax_checkpoint(make_batch, tmp_path, jm=None, jp=None, *, seed, **train_kw):
    """``jax_reference`` over 6 steps, and its orbax checkpoint after the
    third converted by ``checkpoint_from_jax`` under ``tmp_path``."""
    ref = jax_reference(make_batch, jm, jp, steps=6, seed=seed, save_at=3, **train_kw)
    return ref, checkpoint_from_jax(ref.saved, str(tmp_path / "port" / "checkpoint-3"),
                                    meta=ref.saved_meta)


def resumed_losses(ref, tt, make_batch, seed):
    """The port's trainer ``tt``, restored from ``jax_checkpoint``, over the
    reference's batches 4-6: the (JAX, port) losses."""
    rng = np.random.default_rng(seed)
    batches = [make_batch(rng) for _ in ref.metrics]
    return [(mj["train/loss"], tt.training_step([b])["train/loss"])
            for mj, b in zip(ref.metrics[3:], batches[3:])]


@dataclasses.dataclass
class Trajectories:
    """Both trainers' run: each step's (JAX, port) losses and parameters
    (JAX layout, numpy), the last step's metrics, the reference, the port."""

    losses: list
    params: list
    mj: dict
    mt: dict
    reference: Reference
    tt: object


def run_both(make_batch, pair=None, jp=None, *, accum=1, seed=0, trainer="AATTrainer",
             unfreeze_after=None, **train_kw):
    """The port's ``trainer`` beside ``jax_reference``'s run with the same
    arguments (the tiny ``models()`` pair by default), step for step on the
    same batches; every step's metrics carry the same keys in both."""
    jm, tm = pair or models()
    jp = jax_params(jm) if jp is None else jp
    ref = jax_reference(make_batch, jm, jp, accum=accum, seed=seed, trainer=trainer,
                        unfreeze_after=unfreeze_after, **train_kw)
    tt = getattr(ttrainer, trainer)(tm, port_params(jp), TConfig(
        **dict(TRAIN, gradient_accumulation_steps=accum, **train_kw)))
    rng = np.random.default_rng(seed)
    losses, params = [], []
    for step, (mj, jparams) in enumerate(zip(ref.metrics, ref.params)):
        if step == unfreeze_after:
            tt.unfreeze_lm_decoder()
        mt = tt.training_step([make_batch(rng) for _ in range(accum)])
        assert set(mt) == set(mj)
        losses.append((mj["train/loss"], mt["train/loss"]))
        params.append((jparams, jax.tree.map(np.array, to_jax_params(tt.state.params))))
    return Trajectories(losses, params, mj, mt, ref, tt)
