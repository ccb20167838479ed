"""Waveform value type (counterpart of ``aat_tpu/audio.py``): a 1-D numpy
waveform plus its sampling rate, as the host tokenizer takes and returns
them."""

from dataclasses import dataclass

import numpy as np


@dataclass
class AudioWaveform:
    """A 1-D waveform plus its sampling rate."""

    waveform: np.ndarray
    sampling_rate: int

    @property
    def duration_seconds(self) -> float:
        return self.waveform.shape[-1] / self.sampling_rate

    def assert_sampling_rate(self, expected_sampling_rate: int) -> None:
        assert self.sampling_rate == expected_sampling_rate, (
            f"expected sampling rate {expected_sampling_rate}, got {self.sampling_rate}"
        )
