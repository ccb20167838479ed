"""Port mel front end vs the JAX package: framing, the plain mel route and
the Pallas kernel route (interpret mode on the CPU), on seeded speech-like
inputs with per-row lengths. No CUDA kernel runs here, so the arithmetic
of ``csrc/mel.cu`` is emulated on the CPU (its basis layout, its DFT sums
k = 0..399 in one FFMA chain, its power and its banded Slaney fold) and
held to the JAX package's routes and segment tables; the wrapper's
strided launch is checked on the meta device."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aat_tpu.ops import mel as jmel
from aat_tpu.ops import segmentation as jseg
from aat_tpu_torch.ops import mel as tmel
from aat_tpu_torch.ops import segmentation as tseg
from tests.conftest import make_speechlike_waveform
from test_torch_flash_fwd_mma import meta_library  # noqa: F401  (the fixture)


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


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf on f32 values: the product exact in f64, the sum rounded to f64
    and then to f32 (a double rounding that differs from one rounding only
    on rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_melspec(frames: torch.Tensor, dense_fold: bool = False) -> torch.Tensor:
    """The mel kernel's arithmetic on frames ``[..., 400]`` → ``[..., 64]``:
    each column of the kernel-order basis summed over k = 0..399 in one fma
    chain (the ring's 16-k slices keep that order), the power re² + im²
    with the products rounded before the add, each mel folded over its band
    of nonzero weights in bin order (``dense_fold``: over all 201 bins), and
    log10 of the sum floored at 1e-10."""
    basis, filters = tmel._dft_mel_constants(400, 64, 16000, 8000.0)
    kb = torch.from_numpy(tmel.kernel_basis(basis))
    x = frames.reshape(-1, 400).float()
    acc = torch.zeros((x.shape[0], kb.shape[1]), dtype=torch.float32)
    for k0 in range(0, 400, 16):
        for k in range(k0, k0 + 16):
            acc = fma(x[:, k:k + 1], kb[k], acc)
    # the kernel order keeps bins in order: column pair i is bin i
    power = (acc[:, 0::2] * acc[:, 0::2] + acc[:, 1::2] * acc[:, 1::2])[:, :201]
    w = torch.from_numpy(filters)
    total = torch.zeros((x.shape[0], 64), dtype=torch.float32)
    if dense_fold:
        for b in range(201):
            total = fma(power[:, b:b + 1], w[b], total)
    else:
        band = torch.from_numpy(tmel.mel_band(filters)).long()
        first, count = band[:, 0], band[:, 1]
        for step in range(int(count.max())):
            b = (first + step).clamp(max=200)
            nxt = fma(power[:, b], w[b, torch.arange(64)], total)
            total = torch.where(step < count, nxt, total)
    out = torch.log10(torch.clamp_min(total, tmel.MEL_FLOOR))
    return out.reshape(frames.shape[:-1] + (64,))


def test_slaney_band_is_at_most_two_weights_a_bin():
    """The band the kernel folds over: every bin has at most 2 nonzero
    Slaney weights, each mel's nonzero bins are one contiguous band, and
    the host-side band table marks exactly ``filters != 0`` (388 entries)."""
    _, filters = tmel._dft_mel_constants(400, 64, 16000, 8000.0)
    nonzero = filters != 0
    assert nonzero.sum(1).max() == 2 and int(nonzero.sum()) == 388
    band = tmel.mel_band(filters)
    assert band.dtype == np.int32 and band.shape == (64, 2)
    assert int(band[:, 1].min()) >= 1 and int(band[:, 1].max()) == tmel.MAX_BAND
    marked = np.zeros_like(nonzero)
    for m, (first, count) in enumerate(band):
        marked[first:first + count, m] = True
    np.testing.assert_array_equal(marked, nonzero)
    with pytest.raises(ValueError, match="more than two"):
        tmel.mel_band(np.ones((4, 3)))
    with pytest.raises(ValueError, match="over 18"):
        tmel.mel_band(np.ones((19, 1)))


def test_kernel_basis_interleaves_bins_in_thread_order():
    """Thread c reads bins 2c, 2c+1 at column 4c and 104+2c, 105+2c at
    208 + 4c, cos then -sin; bins 201-207 are zero."""
    basis, _ = tmel._dft_mel_constants(400, 64, 16000, 8000.0)
    kb = tmel.kernel_basis(basis)
    assert kb.shape == (400, 416)
    for c in (0, 17, 51):
        for col, b in ((4 * c, 2 * c), (208 + 4 * c, 104 + 2 * c)):
            for e in range(4):
                bin_ = b + e // 2
                want = basis[:, 201 * (e % 2) + bin_] if bin_ < 201 else 0.0
                np.testing.assert_array_equal(kb[:, col + e], want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_kernel_arithmetic_matches_jax(use_pallas):
    """The emulated kernel on the port's framing agrees with JAX's
    ``log_mel_spectrogram_ragged`` (XLA, or the Pallas kernel in interpret
    mode) within 1e-4, and its banded fold equals the dense fold in bin
    order bit for bit."""
    batch, lengths = ragged_batch(5, [0.6] if use_pallas else [1.0, 0.45])
    frames = tmel.frame_waveform_ragged(torch.from_numpy(batch), torch.from_numpy(lengths))
    got = kernel_melspec(frames)
    assert torch.equal(got, kernel_melspec(frames, dense_fold=True))
    want = np.asarray(jmel.log_mel_spectrogram_ragged(
        jnp.asarray(batch), jnp.asarray(lengths), use_pallas=use_pallas))
    np.testing.assert_allclose(got.transpose(-1, -2).numpy(), want, atol=1e-4, rtol=0)


def test_kernel_arithmetic_gives_jax_segment_tables():
    """On the speech-like corpus of tests/conftest.py (the segmentation
    tests' mixed lengths), segment tables from the emulated kernel's
    melspec equal JAX's device path in every slot."""
    rng_waves = [jmel.normalize_waveform(make_speechlike_waveform(np.random.default_rng(i), d))
                 for i, d in enumerate([3.0, 5.0, 7.5])]
    lengths = np.array([w.size for w in rng_waves], np.int32)
    batch = np.zeros((len(rng_waves), lengths.max()), np.float32)
    for i, w in enumerate(rng_waves):
        batch[i, : w.size] = w
    cfg = dict(min_segment_duration_milliseconds=125, max_segment_duration_milliseconds=1500,
               max_segments=128)
    frames = tmel.frame_waveform_ragged(torch.from_numpy(batch), torch.from_numpy(lengths))
    melspec = kernel_melspec(frames).transpose(-1, -2)
    got = tseg.segment_table_from_melspec(melspec, torch.from_numpy(lengths),
                                          tseg.TokenizerConfig(**cfg))
    want = jseg.segment_waveforms(jnp.asarray(batch), jnp.asarray(lengths),
                                  jseg.TokenizerConfig(**cfg))
    for key in ("starts", "ends", "out_lens", "segment_mask", "num_segments"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert int(got["num_segments"].min()) > 1


def test_melspec_kernel_takes_the_strided_view_and_refuses_cpu(request):
    """The framing's view goes to the C entry as it is: its pointer, batch
    and frame strides, no copy; a CPU tensor is refused."""
    batch, lengths = ragged_batch(6, [0.7, 1.3])
    frames = tmel.frame_waveform_ragged(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert not frames.is_contiguous() and frames.stride(-1) == 1
    with pytest.raises(ValueError, match="CUDA"):
        tmel.melspec_kernel(frames)
    lib = request.getfixturevalue("meta_library")
    view = torch.empty_strided(frames.shape, frames.stride(), device="meta")
    out = tmel.melspec_kernel(view)
    assert lib.names == ["aat_mel_forward"]
    args = lib.args[0]
    assert args[0] == view.data_ptr()
    assert args[5:9] == (frames.shape[0], frames.shape[1], frames.stride(0), frames.stride(1))
    assert out.shape == frames.shape[:-1] + (tmel.N_MELS,)
    # a contiguous [N, 400] input is one batch row
    tmel.melspec_kernel(torch.empty((7, 400), device="meta"))
    assert lib.args[1][5:9] == (1, 7, 2800, 400)


@pytest.mark.parametrize("fault", ["stride", "start"])
def test_melspec_kernel_refuses_what_it_cannot_copy_in_16_bytes(meta_library, fault):
    """Frames are copied in 16-byte chunks: a frame stride off 4 elements,
    or a start 2 elements into the buffer, is refused with no fallback."""
    if fault == "stride":
        frames = torch.empty((3, 402), device="meta")[:, :400]
    else:
        frames = torch.empty(3 * 400 + 4, device="meta")[2:2 + 3 * 400].view(3, 400)
    with pytest.raises(ValueError, match="multiples of 4"):
        tmel.melspec_kernel(frames)
    assert meta_library.names == []
