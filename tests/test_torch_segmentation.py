"""Port segmentation device path vs the JAX package: segment tables equal
exactly (every slot, padding included), on the speech-like corpora, a
mixed-length batch and a min > max config; dense materialization and
segment_raw_batch in both modes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aat_tpu.data import ondevice as jdata
from aat_tpu.ops import mel as jmel
from aat_tpu.ops import ragged as jragged
from aat_tpu.ops import segmentation as jseg
from aat_tpu_torch.data import ondevice as tdata
from aat_tpu_torch.ops import ragged as tragged
from aat_tpu_torch.ops import segmentation as tseg
from tests.conftest import make_speechlike_waveform

TABLE_KEYS = ("starts", "ends", "out_lens", "segment_mask", "num_segments")


def speech_batch(durations, seed0=0, normalize=True):
    waves = []
    for i, d in enumerate(durations):
        w = make_speechlike_waveform(np.random.default_rng(seed0 + i), d)
        waves.append(jmel.normalize_waveform(w) if normalize else w)
    lengths = np.array([w.size for w in waves], np.int32)
    batch = np.zeros((len(waves), lengths.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, : w.size] = w
    return batch, lengths


def assert_tables_equal(got, want):
    for key in TABLE_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("durations,min_ms,max_ms", [
    ([3.0, 5.0, 7.5], 125, 1500),   # the default tokenizer, mixed lengths
    ([4.0], 500, 250),              # min > max (the reference's adaptive-training combo)
    ([3.0, 4.5], 250, 1000),
])
def test_segment_tables_equal_jax(durations, min_ms, max_ms):
    cfg_kw = dict(min_segment_duration_milliseconds=min_ms,
                  max_segment_duration_milliseconds=max_ms, max_segments=128)
    batch, lengths = speech_batch(durations)
    want = jseg.segment_waveforms(jnp.asarray(batch), jnp.asarray(lengths),
                                  jseg.TokenizerConfig(**cfg_kw))
    got = tseg.segment_waveforms(torch.from_numpy(batch), torch.from_numpy(lengths),
                                 tseg.TokenizerConfig(**cfg_kw))
    assert_tables_equal(got, want)
    np.testing.assert_allclose(got["melspec"].numpy(), np.asarray(want["melspec"]),
                               atol=1e-4, rtol=0)


def test_smoothing_and_minima_match_jax():
    batch, lengths = speech_batch([2.5, 1.5], seed0=4)
    mel = jmel.log_mel_spectrogram_ragged(jnp.asarray(batch), jnp.asarray(lengths))
    want_s = np.array(jseg.smoothed_amplitude(mel))
    got_s = tseg.smoothed_amplitude(torch.from_numpy(np.array(mel)))
    # the 64-mel mean sums in another order: a few f32 ulps of |x| <= ~30
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-5, rtol=0)
    valid = lengths // 160 + 1 - 12
    want_m = np.asarray(jseg.minima_mask(jnp.asarray(want_s), jnp.asarray(valid)))
    got_m = tseg.minima_mask(torch.from_numpy(want_s), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_m.numpy(), want_m)


def test_uniform_table_equals_jax():
    lengths = np.array([10500, 8000, 3000, 0], np.int32)
    want = jseg.uniform_segment_table(jnp.asarray(lengths), 4000, 8)
    got = tseg.uniform_segment_table(torch.from_numpy(lengths), 4000, 8)
    assert_tables_equal(got, want)


def test_materialize_segments_equals_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 3000)).astype(np.float32)
    starts = np.array([[0, 700, 2900, 0], [100, 1200, 2000, 2600]], np.int32)
    ends = np.array([[700, 1500, 3000, 0], [1200, 2000, 2600, 3000]], np.int32)
    out_lens = np.maximum(ends - starts, np.array([[0, 0, 500, 0], [0, 0, 0, 500]]))
    out_lens = out_lens.astype(np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    ws, wm = jragged.materialize_segments(*map(jnp.asarray, (x, starts, ends, out_lens, mask)),
                                          max_frames=1000)
    gs, gm = tragged.materialize_segments(*map(torch.from_numpy, (x, starts, ends, out_lens, mask)),
                                          max_frames=1000)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("segmentation", ["adaptive", "uniform"])
def test_segment_raw_batch_equals_jax(segmentation):
    batch, lengths = speech_batch([2.0, 3.2], seed0=7, normalize=False)
    kw = dict(segmentation=segmentation, max_segment_frames=4000, max_segments=24,
              sampling_rate=16000)
    want = jdata.segment_raw_batch({"raw_waveforms": jnp.asarray(batch),
                                    "raw_lengths": jnp.asarray(lengths)}, **kw)
    got = tdata.segment_raw_batch({"raw_waveforms": torch.from_numpy(batch),
                                   "raw_lengths": torch.from_numpy(lengths)}, **kw)
    np.testing.assert_array_equal(got["segments_boarders_attention_mask"].numpy(),
                                  np.asarray(want["segments_boarders_attention_mask"]))
    np.testing.assert_array_equal(got["segments_waveforms_mask"].numpy(),
                                  np.asarray(want["segments_waveforms_mask"]))
    # both normalizations reduce over ~5e4 samples in another order
    np.testing.assert_allclose(got["batched_segments"].numpy(),
                               np.asarray(want["batched_segments"]), atol=1e-5, rtol=0)
