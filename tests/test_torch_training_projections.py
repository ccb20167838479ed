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
import torch

from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu.training.trainer import AATTrainerSegmentation as JTrainer
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.trainer import AATTrainerSegmentation as TTrainer
from aat_tpu_torch.utils.port import to_jax_params
from tests._torch_trajectories import (TRAIN, assert_trajectories, captions, efficientnet_models,
                                       jax_params, melspec_batch, pooling_models, port_params,
                                       run_both)
from tests._torch_threads import two_threads  # noqa: F401
from tests.conftest import make_speechlike_waveform


TOL = 1e-6


def speechlike_batch(rng):
    """Two speech-like utterances of 0.9-1.3 s, padded, with captions."""
    waves = [make_speechlike_waveform(rng, d) for d in rng.uniform(0.9, 1.3, 2)]
    raw = np.zeros((2, max(w.size for w in waves)), np.float32)
    lengths = np.array([w.size for w in waves], np.int32)
    for i, w in enumerate(waves):
        raw[i, : w.size] = w
    return {"raw_waveforms": raw, "raw_lengths": lengths, **captions(rng, 2)}


def test_pooling_projection_raw_waveform_trajectory_matches_jax():
    jm, tm = pooling_models(hidden_dim=32, num_heads=4, num_layers=1, ffn_dim=64,
                            max_positions=256)
    jp = jax_params(jm)
    r = run_both(speechlike_batch, (jm, tm), jp, trainer="AATTrainerSegmentation",
                 segmentation="adaptive", max_segment_frames=4000, max_on_device_segments=16)
    jparams, tparams = r.params[-1]
    assert_trajectories(r.losses, jparams, tparams, TOL, loss_rtol=TOL)
    moved = tparams["adapter"]["pooling"]["layers"][0]["attention"]["in_proj"]["kernel"]
    assert np.abs(moved - np.asarray(jp["adapter"]["pooling"]["layers"][0]["attention"]
                                     ["in_proj"]["kernel"])).max() > 0


def test_efficientnet_eval_uses_running_statistics():
    """``evaluate`` (loss) and the generation prefix normalize with the
    running statistics (eval-mode BN): the loss equals JAX's, and a batch
    of other statistics leaves them unmoved."""
    jm, tm, jp = efficientnet_models(4, projection_type="linear", projection_hidden=48)
    enc = jp["audio_encoder"]
    rng = np.random.default_rng(8)
    for bn in [enc["stem"]["bn"], enc["head"]["bn"]] + [
            b[k] for b in enc["blocks"] for k in b if k.endswith("bn")]:
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    cfg = dict(TRAIN, audio_encoder_type="efficient_net", gradient_accumulation_steps=1)
    jt = JTrainer(jm, jp, JConfig(**cfg))
    tt = TTrainer(tm, port_params(jp), TConfig(**cfg))
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
