"""Mel-spectrogram front end (counterpart of ``aat_tpu/ops/mel.py``).

hann(400) window, n_fft=400, hop=160, 64 slaney-norm slaney-scale mel
filters over 0..8 kHz, power-2 spectrum, log10, float32. The numpy
constants are carried here rather than imported: the JAX package's module
imports ``jax`` at its top, and the port runs where JAX is not installed.

The device path frames the padded batch with per-row reflect centering,
then runs the post-framing pipeline (DFT GEMM -> power -> mel GEMM ->
log10) through :func:`melspec_frames`: the hand-written CUDA kernel
``csrc/mel.cu`` for a CUDA tensor, its plain PyTorch version
(:func:`melspec_frames_reference`) for a CPU tensor.

The per-utterance host tokenizer uses :func:`log_mel_spectrogram_exact`,
numpy in float64, bit-identical to the JAX package's host path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_FFT = 400
HOP_LENGTH = 160
N_MELS = 64
SAMPLING_RATE = 16000
FMIN = 0.0
FMAX = 8000.0
MEL_FLOOR = 1e-10


def hann_window(window_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window, float64, bit-identical to numpy.hanning(M+1)[:-1]."""
    length = window_length + 1 if periodic else window_length
    n = np.arange(1 - length, length, 2)
    window = 0.5 + 0.5 * np.cos(np.pi * n / (length - 1))
    return window[:window_length]


def _hertz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, 1e-30) / min_log_hertz) * logstep,
        mels,
    )


def _mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )


def slaney_mel_filter_bank(
    num_frequency_bins: int = N_FFT // 2 + 1,
    num_mel_filters: int = N_MELS,
    min_frequency: float = FMIN,
    max_frequency: float = FMAX,
    sampling_rate: int = SAMPLING_RATE,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters, float64
    ``[num_frequency_bins, num_mel_filters]``."""
    mel_min = _hertz_to_mel_slaney(min_frequency)
    mel_max = _hertz_to_mel_slaney(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    filters = np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))

    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    filters *= enorm[np.newaxis, :]
    return filters


def num_mel_frames(waveform_length: int, hop_length: int = HOP_LENGTH) -> int:
    """Number of STFT frames for a center-padded signal."""
    return waveform_length // hop_length + 1


@functools.lru_cache(maxsize=4)
def _window_and_filters(n_fft: int, n_mels: int, sampling_rate: int, fmax: float):
    """Hann window ``[n_fft]`` and Slaney filters ``[bins, n_mels]``, float64."""
    window = hann_window(n_fft)
    filters = slaney_mel_filter_bank(
        num_frequency_bins=n_fft // 2 + 1, num_mel_filters=n_mels,
        max_frequency=fmax, sampling_rate=sampling_rate,
    )
    return window, filters


def log_mel_spectrogram_exact(
    waveform: np.ndarray,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    n_mels: int = N_MELS,
    sampling_rate: int = SAMPLING_RATE,
    fmax: float = FMAX,
) -> np.ndarray:
    """Host melspec of the per-utterance tokenizer, float32 ``[n_mels, T]``:
    float64 rFFT of hann-windowed reflect-centered frames, each frame's
    spectrum rounded through complex64 (the reference stores frames in a
    complex64 buffer; that rounding is part of the spec), float64 power and
    mel projection with a 1e-10 floor, log10, cast to float32."""
    window, mel_filters = _window_and_filters(n_fft, n_mels, sampling_rate, fmax)
    half = n_fft // 2
    padded = np.pad(np.asarray(waveform), (half, half), mode="reflect").astype(np.float64)
    num_frames = 1 + (padded.size - n_fft) // hop_length
    frames = np.lib.stride_tricks.sliding_window_view(padded, n_fft)[::hop_length][:num_frames]
    spec_c64 = np.fft.rfft(frames * window[np.newaxis, :], n=n_fft, axis=-1).astype(np.complex64)
    power = np.abs(spec_c64.astype(np.complex128)) ** 2.0  # [T, bins] float64
    mel = np.maximum(MEL_FLOOR, np.dot(mel_filters.T, power.T))  # [n_mels, T]
    return np.log10(mel).astype(np.float32)


def normalize_waveform(waveform: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Mean/std normalization of one host waveform before the melspec."""
    return (waveform - waveform.mean()) / (waveform.std() + eps)


@functools.lru_cache(maxsize=4)
def _dft_mel_constants(n_fft: int, n_mels: int, sampling_rate: int, fmax: float):
    """Windowed DFT basis ``[n_fft, 2*bins]`` (cos | -sin) and mel filters
    ``[bins, n_mels]``, numpy float32."""
    window, mel_filters = _window_and_filters(n_fft, n_mels, sampling_rate, fmax)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft
    basis = np.concatenate(
        [np.cos(angle) * window[:, None], -np.sin(angle) * window[:, None]], axis=1
    )
    return basis.astype(np.float32), mel_filters.astype(np.float32)


# the mel kernel's column tile: 52 threads across the columns, 4 bins each
KERNEL_BINS = 208
# the longest band of nonzero weights a mel filter may have in the kernel's
# fold (csrc/mel.cu kMaxBand); the reference's filters have 1-18 bins
MAX_BAND = 18


def kernel_basis(basis: np.ndarray) -> np.ndarray:
    """The DFT basis ``[n_fft, 2*bins]`` (cos | -sin) in the mel kernel's
    order, ``[n_fft, 2*KERNEL_BINS]``: cos and sin interleaved per bin, bins
    padded with zeros to ``KERNEL_BINS``. Column j = 208·h + 4·c + e holds
    bin 104·h + 2·c + e // 2, its cos for even e and its -sin for odd e, so
    kernel thread c reads bins 2c, 2c+1 and 104+2c, 105+2c as two float4s."""
    n, bins = basis.shape[0], basis.shape[1] // 2
    j = np.arange(2 * KERNEL_BINS)
    half, within = j // KERNEL_BINS, j % KERNEL_BINS
    bin_ = (KERNEL_BINS // 2) * half + 2 * (within // 4) + (within % 4) // 2
    part = within % 2
    out = np.zeros((n, 2 * KERNEL_BINS), basis.dtype)
    real = bin_ < bins
    out[:, real] = basis[:, part[real] * bins + bin_[real]]
    return out


def mel_band(filters: np.ndarray) -> np.ndarray:
    """Each mel filter's nonzero bins as ``[n_mels, 2]`` int32 (first bin,
    count): a Slaney filter is nonzero on one contiguous band of at most
    ``MAX_BAND`` bins, and a bin lies in at most two bands. Raises if
    ``filters`` is not so banded."""
    nonzero = filters != 0
    if nonzero.sum(1).max(initial=0) > 2:
        raise ValueError("a bin has more than two nonzero mel weights")
    band = np.zeros((filters.shape[1], 2), np.int32)
    for m in range(filters.shape[1]):
        bins = np.nonzero(nonzero[:, m])[0]
        if bins.size and not np.array_equal(bins, np.arange(bins[0], bins[0] + bins.size)):
            raise ValueError(f"mel filter {m} is not one contiguous band")
        if bins.size > MAX_BAND:
            raise ValueError(f"mel filter {m} spans {bins.size} bins, over {MAX_BAND}")
        band[m] = (bins[0], bins.size) if bins.size else (0, 0)
    return band


@functools.lru_cache(maxsize=8)
def _constants_on(device: torch.device):
    """The f32 basis and filters as tensors on ``device``, copied once."""
    basis, filters = _dft_mel_constants(N_FFT, N_MELS, SAMPLING_RATE, FMAX)
    return (torch.from_numpy(basis).to(device), torch.from_numpy(filters).to(device))


@functools.lru_cache(maxsize=8)
def _kernel_constants_on(device: torch.device):
    """The mel kernel's constants on ``device``, copied once: the basis in
    its order (:func:`kernel_basis`), the filters and the band table
    (:func:`mel_band`)."""
    basis, filters = _dft_mel_constants(N_FFT, N_MELS, SAMPLING_RATE, FMAX)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (kernel_basis(basis), filters, mel_band(filters)))


def frame_waveform_ragged(
    waveforms: torch.Tensor,
    lengths: torch.Tensor,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
) -> torch.Tensor:
    """Frame a padded ``[B, L_max]`` batch with *per-row* reflect centering
    → ``[B, L_max // hop + 1, n_fft]``.

    Index ``i`` outside ``[0, len)`` reflects as ``-i`` / ``2*len - 2 - i``.
    ``F.pad(mode="reflect")`` cannot take per-row lengths, so the tail
    reflection is a gather on each row's length written by a scatter.
    Frames past a row's valid frame count hold stale content; callers mask
    them.
    """
    b, l_max = waveforms.shape
    half = n_fft // 2
    w = waveforms.to(torch.float32)
    n_frames = num_mel_frames(l_max, hop_length)
    p = max(-(-(l_max + 2 * half) // hop_length),
            n_frames + (-(-n_fft // hop_length))) * hop_length

    left = w[:, 1 : half + 1].flip(-1)
    padded = torch.cat(
        [left, w, w.new_zeros((b, p - half - l_max))], dim=1)

    # per-row tail reflection: padded[half + len + j] = w[len - 2 - j]
    length = lengths.to(device=w.device, dtype=torch.int64)
    j = torch.arange(half, device=w.device)
    src_idx = (length[:, None] - 2 - j[None, :]).clamp(0, l_max - 1)
    src = torch.gather(w, 1, src_idx)
    cols = (half + length[:, None] + j[None, :]).clamp(max=p - 1)
    padded = padded.scatter(1, cols, src)
    return padded.unfold(-1, n_fft, hop_length)[:, :n_frames]


def melspec_frames_reference(frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the mel kernel: frames ``[..., n_fft]`` →
    log-mel ``[..., n_mels]`` by two full-f32 matmuls + log10 (the JAX
    package's ``_mel_from_frames`` XLA route). On a CUDA tensor the caller
    must have TF32 matmuls off for full f32 (PyTorch's default)."""
    basis, filters = _constants_on(frames.device)
    bins = basis.shape[1] // 2
    spec = torch.matmul(frames.to(torch.float32), basis)
    power = spec[..., :bins] ** 2 + spec[..., bins:] ** 2
    mel = torch.clamp_min(torch.matmul(power, filters), MEL_FLOOR)
    return torch.log10(mel)


def melspec_frames(frames: torch.Tensor) -> torch.Tensor:
    """Frames ``[..., n_fft]`` f32 → log-mel ``[..., n_mels]`` f32.

    A CUDA tensor goes through the hand-written kernel ``csrc/mel.cu`` (or
    raises); only a CPU tensor takes the plain version."""
    if frames.device.type == "cpu":
        return melspec_frames_reference(frames)
    return melspec_kernel(frames)


def melspec_kernel(frames: torch.Tensor) -> torch.Tensor:
    """Launch ``aat_mel_forward`` (replaces the TPU kernel
    aat_tpu/ops/mel_pallas.py:36 ``_mel_kernel``) on a CUDA tensor. Frames
    ``[N, n_fft]`` or ``[B, F, n_fft]`` are read through their strides, so
    :func:`frame_waveform_ragged`'s view goes in without a copy; the kernel
    copies them in 16-byte chunks, so strides must be multiples of 4 and the
    start 16-byte aligned (else this raises)."""
    from aat_tpu_torch.runtime import kernels

    kernels.check_cuda(frames, "mel")
    if frames.dtype != torch.float32 or frames.shape[-1] != N_FFT or frames.dim() < 2:
        raise ValueError(f"mel kernel takes f32 [..., {N_FFT}] frames, "
                         f"got {frames.dtype} {tuple(frames.shape)}")
    lead = frames.shape[:-1]
    rows = frames[None] if frames.dim() == 2 else frames.reshape(-1, *frames.shape[-2:])
    n_batch, n_per = rows.shape[0], rows.shape[1]
    # (a stride of a size-1 axis is never used)
    if (rows.stride(-1) != 1 or rows.data_ptr() % 16
            or any(rows.stride(i) % 4 for i in (0, 1) if rows.shape[i] > 1)):
        raise ValueError(f"mel kernel needs frame strides in multiples of 4 elements, a unit "
                         f"last stride and a 16-byte-aligned start, got {tuple(rows.stride())}")
    basis, filters, band = _kernel_constants_on(frames.device)
    out = torch.empty((n_batch * n_per, N_MELS), dtype=torch.float32, device=frames.device)
    kernels.launch("aat_mel_forward", frames.device, rows.data_ptr(), basis.data_ptr(),
                   filters.data_ptr(), band.data_ptr(), out.data_ptr(), n_batch, n_per,
                   rows.stride(0), rows.stride(1))
    melspec_kernel.launches += 1
    return out.reshape(lead + (N_MELS,))


melspec_kernel.launches = 0


def log_mel_spectrogram_ragged(waveforms: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Melspec for a padded ``[B, L_max]`` batch with per-row reflect
    framing → float32 ``[B, n_mels, T_max]`` at the reference's settings
    (400-point FFT, hop 160, 64 mels, 16 kHz); frames past
    ``len//hop + 1`` per row are garbage and must be masked by the caller."""
    frames = frame_waveform_ragged(waveforms, lengths)
    return melspec_frames(frames).transpose(-1, -2)
