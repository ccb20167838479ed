"""``AATTrainerSegmentation`` against the JAX package's over 3 steps at
tiny widths, f32, on the two encoder/projection paths ported last:

- the ``transformer_encoder`` projection on raw-waveform batches segmented
  on the device (adaptive), as JAX ``tests/test_end_to_end.py:67-106``;
- EfficientNet-b0's evaluation on melspec batches (eval-mode BN, the
  running statistics); its training trajectories are in
  ``tests/test_torch_training_efficientnet.py``.

Losses within 1e-6 relative, parameters within 1e-6. Dropout is 0 (the
two packages derive their dropout seeds differently)."""


import jax
import numpy as np
import pytest
import torch

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import efficientnet as jeff
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu.training.trainer import AATTrainerSegmentation as JTrainer
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import efficientnet as teff
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.trainer import AATTrainerSegmentation as TTrainer
from aat_tpu_torch.utils.port import from_jax_params, to_jax_params
from tests.conftest import make_speechlike_waveform


TOL = 1e-6
TRAIN = dict(learning_rate=1e-4, warmup_steps=2, max_steps=10, compute_dtype="float32",
             logging_steps=1000, eval_steps=0, save_steps=0)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads a test: the test workers share the host's cores,
    and many-threaded convolutions on shared cores run tens of times
    slower (``tests/test_torch_scripts.py`` does the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def captions(rng, b, c=6, vocab=100):
    ids = rng.integers(1, vocab, (b, c))
    mask = np.ones((b, c), np.int32)
    mask[-1, c - 2:] = 0
    return {"input_ids": ids, "attention_mask": mask, "input_ids_attention_mask": mask}


def raw_batch(rng):
    """Two speech-like utterances of 0.9-1.3 s, padded, with captions."""
    waves = [make_speechlike_waveform(rng, d) for d in rng.uniform(0.9, 1.3, 2)]
    raw = np.zeros((2, max(w.size for w in waves)), np.float32)
    lengths = np.array([w.size for w in waves], np.int32)
    for i, w in enumerate(waves):
        raw[i, : w.size] = w
    return {"raw_waveforms": raw, "raw_lengths": lengths, **captions(rng, 2)}


def melspec_batch(rng, b=2, s=2):
    smask = np.ones((b, s), np.int32)
    smask[1, 1] = 0  # a padded segment
    return {"batched_segments_melspectrograms": rng.normal(0, 1, (b, s, 64, 26)).astype(
        np.float32), "segments_boarders_attention_mask": smask, **captions(rng, b)}


def run(jm, tm, jp, cfg, make_batch, accum, steps=3, seed=0, record_first=False):
    """Both trainers from the weights ``jp`` over the same batches: per-step
    losses and the final parameters (JAX layout), and with
    ``record_first`` the parameters after the first step too."""
    jt = JTrainer(jm, jp, JConfig(**cfg, gradient_accumulation_steps=accum))
    # a copy: the port's tensors share the numpy arrays' memory and train in place
    tt = TTrainer(tm, from_jax_params(jax.tree.map(np.array, jp)),
                  TConfig(**cfg, gradient_accumulation_steps=accum))
    rng = np.random.default_rng(seed)
    losses, first = [], None
    for _ in range(steps):
        micro = [make_batch(rng) for _ in range(accum)]
        mj, mt = jt.training_step(micro), tt.training_step(micro)
        assert set(mt) == set(mj)
        losses.append((mj["train/loss"], mt["train/loss"]))
        if first is None:  # copies: both trainers update their buffers in place
            first = tuple(jax.tree.map(np.array, t) for t in (
                jax.device_get(jt.state.params), to_jax_params(tt.state.params)))
    if record_first:
        return losses, jax.device_get(jt.state.params), to_jax_params(tt.state.params), first
    return losses, jax.device_get(jt.state.params), to_jax_params(tt.state.params)


def assert_trajectory(losses, jparams, tparams):
    for step, (lj, lt) in enumerate(losses):
        assert np.isfinite(lt) and abs(lj - lt) <= TOL * abs(lj), (step, lj, lt)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = jax.tree.leaves(tparams)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_pooling_projection_raw_waveform_trajectory_matches_jax():
    pool = dict(hidden_dim=32, num_heads=4, num_layers=1, ffn_dim=64, max_positions=256)
    aslm = dict(projection_type="transformer_encoder", audio_encoder_hidden=32, lm_hidden=32,
                dropout=0.0)
    jm = jaslm.AslmModel(jaslm.AslmConfig(pooling=jaslm.PoolingConfig(**pool), **aslm),
                         jhub.tiny_test_config(), jllm.tiny_test_config())
    tm = taslm.AslmModel(taslm.AslmConfig(pooling=taslm.PoolingConfig(**pool), **aslm),
                         thub.tiny_test_config(), tllm.tiny_test_config())
    jp = {"audio_encoder": jhub.init_hubert_params(0, jm.audio_encoder_config),
          "adapter": jaslm.init_aslm_params(1, jm.config),
          "lm_decoder": jllm.init_llama_params(2, jm.lm_config)}
    cfg = dict(TRAIN, segmentation="adaptive", max_segment_frames=4000,
               max_on_device_segments=16)
    losses, jparams, tparams = run(jm, tm, jp, cfg, raw_batch, accum=1)
    assert_trajectory(losses, jparams, tparams)
    moved = tparams["adapter"]["pooling"]["layers"][0]["attention"]["in_proj"]["kernel"]
    assert np.abs(moved - np.asarray(jp["adapter"]["pooling"]["layers"][0]["attention"]
                                     ["in_proj"]["kernel"])).max() > 0


def test_efficientnet_eval_uses_running_statistics():
    """``evaluate`` (loss) and the generation prefix normalize with the
    running statistics (eval-mode BN): the loss equals JAX's, and a batch
    of other statistics leaves them unmoved."""
    aslm = dict(projection_type="linear", audio_encoder_hidden=1280, lm_hidden=32,
                projection_hidden=48)
    jm = jaslm.AslmModel(jaslm.AslmConfig(**aslm), jeff.EfficientNetConfig(),
                         jllm.tiny_test_config(), audio_encoder_type="efficient_net")
    tm = taslm.AslmModel(taslm.AslmConfig(**aslm), teff.EfficientNetConfig(),
                         tllm.tiny_test_config(), audio_encoder_type="efficient_net")
    jp = {"audio_encoder": jeff.init_efficientnet_params(4),
          "adapter": jaslm.init_aslm_params(1, jm.config),
          "lm_decoder": jllm.init_llama_params(3, jm.lm_config)}
    enc = jp["audio_encoder"]
    rng = np.random.default_rng(8)
    for bn in [enc["stem"]["bn"], enc["head"]["bn"]] + [
            b[k] for b in enc["blocks"] for k in b if k.endswith("bn")]:
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    cfg = dict(TRAIN, audio_encoder_type="efficient_net", gradient_accumulation_steps=1)
    jt = JTrainer(jm, jp, JConfig(**cfg))
    tt = TTrainer(tm, from_jax_params(jax.tree.map(np.array, jp)), TConfig(**cfg))
    batch = melspec_batch(rng)
    before = to_jax_params(tt.state.params)
    got, want = tt.evaluate([batch])["eval/loss"], jt.evaluate([batch])["eval/loss"]
    assert abs(got - want) <= 1e-5 * abs(want)
    after = to_jax_params(tt.state.params)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_array_equal(a, b)
    prefix = {"prefix_input_ids": batch["input_ids"][:, :2],
              "prefix_attention_mask": np.ones((2, 2), np.int32)}
    dev = {k: torch.as_tensor(v) for k, v in {**batch, **prefix}.items()}
    ins_t = tt._prefix_inputs(tt.state.params, dev)
    ins_j = jt._prefix_inputs(jt.state.params, {**batch, **prefix})
    ref = np.asarray(ins_j["inputs_embeds"])
    assert np.abs(ins_t["inputs_embeds"].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
