"""Adaptive audio amplitude tokenizer, public API (counterpart of
``aat_tpu/tokenizer.py``).

- :meth:`AdaptiveAudioTokenizer.tokenize`: the per-utterance host path
  (numpy, float64 melspec, the reference's float32 boundary numerics),
  returning segment :class:`~aat_tpu_torch.audio.AudioWaveform` pieces and
  the melspec. The offline embedding pipeline runs it.
- :meth:`AdaptiveAudioTokenizer.tokenize_batch`: the fixed-shape batched
  device path (:func:`~aat_tpu_torch.ops.segmentation.segment_waveforms`)
  on a padded ``[B, L]`` tensor.
- :func:`tokenize_dense`: the device path's table plus the dense segment
  batch, over chunks of the batch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from aat_tpu_torch.audio import AudioWaveform
from aat_tpu_torch.ops import mel as mel_ops
from aat_tpu_torch.ops.ragged import materialize_segments
from aat_tpu_torch.ops import segmentation as seg_ops
from aat_tpu_torch.ops.segmentation import TokenizerConfig


class AdaptiveAudioTokenizer:
    """Variable-length speech segmentation by smoothed-amplitude minima."""

    def __init__(self, config: TokenizerConfig = TokenizerConfig()):
        self.config = config

    @classmethod
    def create(
        cls,
        running_mean_points: int = 12,
        min_segment_duration_milliseconds: int = 125,
        max_segment_duration_milliseconds: int = 1500,
        n_fft: int = 400,
        hop_length: int = 160,
        num_mel_filters: int = 64,
        sampling_rate: int = 16000,
        max_amplitude_for_minima: float = 15.0,
    ) -> "AdaptiveAudioTokenizer":
        return cls(TokenizerConfig(
            running_mean_points=running_mean_points,
            min_segment_duration_milliseconds=min_segment_duration_milliseconds,
            max_segment_duration_milliseconds=max_segment_duration_milliseconds,
            n_fft=n_fft,
            hop_length=hop_length,
            num_mel_filters=num_mel_filters,
            sampling_rate=sampling_rate,
            max_amplitude_for_minima=max_amplitude_for_minima,
        ))

    @property
    def sampling_rate(self) -> int:
        return self.config.sampling_rate

    @property
    def hop_length(self) -> int:
        return self.config.hop_length

    @property
    def num_mel_filters(self) -> int:
        return self.config.num_mel_filters

    @property
    def running_mean_points(self) -> int:
        return self.config.running_mean_points

    @property
    def min_segment_frames(self) -> int:
        return self.config.min_segment_frames

    @property
    def max_segment_frames(self) -> int:
        return self.config.max_segment_frames

    # ---- host path --------------------------------------------------------

    def get_melspec(self, waveform: np.ndarray) -> np.ndarray:
        """Host log-mel spectrogram (``[n_mels, T]`` float32)."""
        c = self.config
        return mel_ops.log_mel_spectrogram_exact(
            waveform, n_fft=c.n_fft, hop_length=c.hop_length,
            n_mels=c.num_mel_filters, sampling_rate=c.sampling_rate,
        )

    def pretokenize(self, waveform: np.ndarray, melspec: Optional[np.ndarray] = None
                    ) -> Tuple[List[int], np.ndarray]:
        """Boundary sample indices (minima · hop, then the waveform end) and
        the melspec."""
        return seg_ops.pretokenize_exact(waveform, melspec, self.config)

    def segment_spans(self, waveform: np.ndarray, melspec: Optional[np.ndarray] = None
                      ) -> Tuple[List[Tuple[int, int, int]], np.ndarray]:
        """``(start, end, out_len)`` spans after merge/split/pad, and the
        melspec."""
        boundaries, melspec = self.pretokenize(waveform, melspec)
        spans = seg_ops.process_boundaries_exact(int(waveform.shape[-1]), boundaries,
                                                 self.config)
        return spans, melspec

    def tokenize(self, audio: AudioWaveform, melspec: Optional[np.ndarray] = None
                 ) -> Tuple[List[AudioWaveform], np.ndarray]:
        """Segment waveforms (a trailing short segment right-padded with
        zeros to the minimum length) and the melspec. Asserts fewer than 300
        segments and that the segments cover the waveform."""
        audio.assert_sampling_rate(self.config.sampling_rate)
        waveform = audio.waveform
        spans, melspec = self.segment_spans(waveform, melspec)
        segments: List[AudioWaveform] = []
        for start, end, out_len in spans:
            piece = waveform[start:end]
            if out_len > end - start:
                padded = np.zeros(out_len, dtype=piece.dtype)
                padded[: end - start] = piece
                piece = padded
            segments.append(AudioWaveform(piece, audio.sampling_rate))
        assert len(segments) < 300
        assert sum(s.waveform.shape[-1] for s in segments) >= waveform.shape[-1]
        return segments, melspec

    # ---- device path ------------------------------------------------------

    def tokenize_batch(self, waveforms, lengths):
        """Fixed-shape batch segmentation of a padded ``[B, L]`` tensor; see
        :func:`aat_tpu_torch.ops.segmentation.segment_waveforms`."""
        return seg_ops.segment_waveforms(waveforms, lengths, self.config)


def tokenize_dense(waveforms: torch.Tensor, lengths: torch.Tensor,
                   config: TokenizerConfig = TokenizerConfig(), batch_chunk: int = 8):
    """The device tokenizer and the dense segment batch of a padded
    ``[B, L]`` batch: :func:`~aat_tpu_torch.ops.segmentation.segment_waveforms`
    then :func:`~aat_tpu_torch.ops.ragged.materialize_segments`, over chunks
    of the batch of the largest size up to ``batch_chunk`` that divides it
    (one chunk when ``B <= batch_chunk``). On CUDA tensors the mel step is
    the ``csrc/mel.cu`` kernel.

    Returns ``(table, segments, frame_mask)``: ``table`` is the
    :func:`segment_waveforms` dict (leaves ``[B, ...]``), without ``melspec``
    when chunked (call :meth:`AdaptiveAudioTokenizer.tokenize_batch` for
    it); ``segments`` is ``[B, S_max, max_frames]`` float32 and
    ``frame_mask`` its bool validity mask. Chunked and flat results are
    equal."""
    b = waveforms.shape[0]
    max_frames = config.max_segment_frames

    def one_chunk(wv, ln):
        table = seg_ops.segment_waveforms(wv, ln, config)
        segments, frame_mask = materialize_segments(
            wv, table["starts"], table["ends"], table["out_lens"], table["segment_mask"],
            max_frames)
        return table, segments, frame_mask

    if b <= batch_chunk:
        return one_chunk(waveforms, lengths)
    chunk = max(d for d in range(1, batch_chunk + 1) if b % d == 0)
    parts = []
    for i in range(0, b, chunk):
        table, segments, frame_mask = one_chunk(waveforms[i:i + chunk], lengths[i:i + chunk])
        table.pop("melspec")
        parts.append((table, segments, frame_mask))
    table = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    return (table, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts]))
