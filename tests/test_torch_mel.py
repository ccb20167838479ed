"""Port mel front end vs the JAX package: framing, the plain mel route and
the Pallas kernel route (interpret mode on the CPU), on seeded speech-like
inputs with per-row lengths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aat_tpu.ops import mel as jmel
from aat_tpu_torch.ops import mel as tmel
from tests.conftest import make_speechlike_waveform


def ragged_batch(seed, durations):
    rng = np.random.default_rng(seed)
    waves = [jmel.normalize_waveform(make_speechlike_waveform(rng, d)) for d in durations]
    l_max = max(w.size for w in waves)
    batch = np.zeros((len(waves), l_max), np.float32)
    for i, w in enumerate(waves):
        batch[i, : w.size] = w
    return batch, np.array([w.size for w in waves], np.int32)


def test_numpy_constants_match_jax():
    a = tmel._dft_mel_constants(400, 64, 16000, 8000.0)
    b = jmel._dft_mel_constants(400, 64, 16000, 8000.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tmel.hann_window(400), jmel.hann_window(400))


def test_frame_waveform_ragged_bitwise():
    batch, lengths = ragged_batch(0, [0.7, 1.0, 0.45])
    got = tmel.frame_waveform_ragged(torch.from_numpy(batch), torch.from_numpy(lengths))
    want = np.asarray(jmel.frame_waveform_ragged(jnp.asarray(batch), jnp.asarray(lengths)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("durations", [[1.0], [0.7, 1.3, 0.45]])
def test_log_mel_ragged_matches_jax(durations):
    # the two f32 GEMMs sum in another order than XLA's; 1e-4 abs on log10
    batch, lengths = ragged_batch(1, durations)
    got = tmel.log_mel_spectrogram_ragged(torch.from_numpy(batch), torch.from_numpy(lengths))
    want = np.asarray(jmel.log_mel_spectrogram_ragged(jnp.asarray(batch), jnp.asarray(lengths)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_log_mel_matches_jax_pallas_route():
    # short clip: the Pallas kernel runs in interpret mode on the CPU
    batch, lengths = ragged_batch(2, [0.6])
    got = tmel.log_mel_spectrogram_ragged(torch.from_numpy(batch), torch.from_numpy(lengths))
    want = np.asarray(jmel.log_mel_spectrogram_ragged(
        jnp.asarray(batch), jnp.asarray(lengths), use_pallas=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cpu_tensor_takes_plain_version_and_kernel_refuses_cpu():
    frames = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (5, 400)).astype(np.float32))
    np.testing.assert_array_equal(tmel.melspec_frames(frames).numpy(),
                                  tmel.melspec_frames_reference(frames).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tmel.melspec_kernel(frames)
