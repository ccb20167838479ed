"""Adaptive audio amplitude tokenizer, public API (counterpart of
``aat_tpu/tokenizer.py``).

- :meth:`AdaptiveAudioTokenizer.tokenize`: the per-utterance host path
  (numpy, float64 melspec, the reference's float32 boundary numerics),
  returning segment :class:`~aat_tpu_torch.audio.AudioWaveform` pieces and
  the melspec. The offline embedding pipeline runs it.
- :meth:`AdaptiveAudioTokenizer.tokenize_batch`: the fixed-shape batched
  device path (:func:`~aat_tpu_torch.ops.segmentation.segment_waveforms`)
  on a padded ``[B, L]`` tensor.

``tokenize_dense`` (the table plus the dense segment batch in one call) is
not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from aat_tpu_torch.audio import AudioWaveform
from aat_tpu_torch.ops import mel as mel_ops
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
