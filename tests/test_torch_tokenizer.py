"""Port host tokenizer (``aat_tpu_torch.tokenizer``) vs the JAX package's
``AdaptiveAudioTokenizer.tokenize``: spans and segment waveforms equal and
the float64-built melspec bitwise equal, on speech-like audio, silence,
and a crafted melspec whose minima give a span under the minimum length
(merged forward), one over the maximum (split) and a short tail (padded).
Also the host routines one by one and the device ``tokenize_batch``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aat_tpu.audio import AudioWaveform as JWave
from aat_tpu.ops import mel as jmel
from aat_tpu.ops import segmentation as jseg
from aat_tpu.tokenizer import AdaptiveAudioTokenizer as JTok
from aat_tpu_torch.audio import AudioWaveform as TWave
from aat_tpu_torch.ops import mel as tmel
from aat_tpu_torch.ops import segmentation as tseg
from aat_tpu_torch.runtime import host_ops
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer as TTok
from tests.conftest import make_speechlike_waveform


def crafted_case():
    """A melspec whose smoothed amplitude peaks near frames 8, 214 and 324
    (tilted triangular bumps wider than the 12-frame smoothing window: one
    strict maximum each), over a waveform that ends 1000 samples after the
    last boundary. The first span is under the minimum, the second over
    the maximum, the tail short."""
    frames = 360
    a = np.full(frames, 20.0)
    t = np.arange(frames)
    for t0 in (15, 221, 331):
        near = np.abs(t - t0) < 12
        a[near] += 12.0 - np.abs(t - t0)[near] + 0.05 * (t - t0)[near]
    mel = np.repeat((-a / 10.0)[None, :], 64, axis=0).astype(np.float32)
    last = int(jseg.find_amplitude_minima_exact(mel)[-1]) * 160
    return np.random.default_rng(9).normal(0, 1, last + 1000), mel


def case(name):
    if name == "speech":
        return jmel.normalize_waveform(make_speechlike_waveform(np.random.default_rng(2), 6.0)), None
    if name == "silence":
        return np.zeros(4 * 16000), None
    return crafted_case()


@pytest.mark.parametrize("name", ["speech", "silence", "crafted"])
def test_tokenize_equals_jax(name):
    wave, mel = case(name)
    want_segs, want_mel = JTok().tokenize(JWave(wave, 16000), mel)
    got_segs, got_mel = TTok().tokenize(TWave(wave, 16000), mel)
    assert got_mel.dtype == np.float32
    np.testing.assert_array_equal(got_mel, want_mel)
    assert len(got_segs) == len(want_segs)
    for g, w in zip(got_segs, want_segs):
        assert g.sampling_rate == w.sampling_rate
        np.testing.assert_array_equal(g.waveform, w.waveform)
    want_spans, _ = JTok().segment_spans(wave, mel)
    got_spans, _ = TTok().segment_spans(wave, mel)
    assert got_spans == want_spans
    if name == "speech":
        assert len(got_spans) > 3
    if name == "silence":  # one span over the maximum, split
        assert len(got_spans) == 3 and got_spans[-1][2] - (got_spans[-1][1] - got_spans[-1][0]) == 0
    if name == "crafted":
        boundaries, _ = TTok().pretokenize(wave, mel)
        lengths = np.diff([0] + boundaries)
        assert lengths.min() < TTok().min_segment_frames  # a span merged forward
        assert max(e - s for s, e, _ in got_spans) == TTok().max_segment_frames  # a split
        start, end, out_len = got_spans[-1]
        assert out_len == TTok().min_segment_frames > end - start  # a padded tail
        assert np.all(got_segs[-1].waveform[end - start:] == 0)


def test_host_routines_equal_jax():
    wave = jmel.normalize_waveform(make_speechlike_waveform(np.random.default_rng(5), 3.0))
    mel = tmel.log_mel_spectrogram_exact(wave)
    np.testing.assert_array_equal(mel, jmel.log_mel_spectrogram_exact(wave))
    np.testing.assert_array_equal(tmel.normalize_waveform(wave), jmel.normalize_waveform(wave))
    s = tseg.smoothed_amplitude_exact(mel)
    np.testing.assert_array_equal(s, jseg.smoothed_amplitude_exact(mel))
    np.testing.assert_array_equal(tseg.find_amplitude_minima_exact(mel),
                                  jseg.find_amplitude_minima_exact(mel))
    assert host_ops.find_minima(s[:2]).shape == (0,)
    for length, lo, hi in ((48000, 2000, 24000), (49000, 2000, 24000), (25000, 2000, 24000),
                           (7000, 4000, 3000)):
        assert tseg.split_sizes_for_span(length, lo, hi) == jseg.split_sizes_for_span(length, lo, hi)
    for n, bounds in ((20000, [1000, 8000, 20000]), (9000, [8000, 9000]), (30000, [30000])):
        assert tseg.process_boundaries_exact(n, bounds) == jseg.process_boundaries_exact(n, bounds)


def test_tokenizer_properties_and_create():
    kw = dict(min_segment_duration_milliseconds=250, max_segment_duration_milliseconds=1000)
    got, want = TTok.create(**kw), JTok.create(**kw)
    for name in ("sampling_rate", "hop_length", "num_mel_filters", "running_mean_points",
                 "min_segment_frames", "max_segment_frames"):
        assert getattr(got, name) == getattr(want, name), name
    with pytest.raises(AssertionError):
        got.tokenize(TWave(np.zeros(800), 8000))


def test_tokenize_batch_equals_jax():
    waves = [jmel.normalize_waveform(make_speechlike_waveform(np.random.default_rng(i), d))
             for i, d in enumerate((2.0, 3.5))]
    lengths = np.array([w.size for w in waves], np.int32)
    batch = np.zeros((2, lengths.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, : w.size] = w
    want = JTok().tokenize_batch(jnp.asarray(batch), jnp.asarray(lengths))
    got = TTok().tokenize_batch(torch.from_numpy(batch), torch.from_numpy(lengths))
    for key in ("starts", "ends", "out_lens", "segment_mask", "num_segments"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
