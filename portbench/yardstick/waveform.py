"""The benchmark's audio: speech-like waveforms from a seed (the generator
of ``chip_smoke.speechlike_waveform`` and the tests' corpus, drawn in
float32 and in bulk): bursts of noise under a Hann envelope over a 220 Hz
tone, separated by near-silence, so the adaptive tokenizer finds
boundaries where speech would have them."""

from __future__ import annotations

import numpy as np

SAMPLING_RATE = 16000


def speechlike(rng: np.random.Generator, samples: int) -> np.ndarray:
    """One float32 waveform of ``samples`` samples."""
    envelope = np.zeros(samples, np.float32)
    pos = 0
    while pos < samples:
        burst = int(rng.uniform(0.15, 0.6) * SAMPLING_RATE)
        gap = int(rng.uniform(0.05, 0.3) * SAMPLING_RATE)
        envelope[pos: pos + burst] = np.hanning(max(burst, 2))[: max(samples - pos, 0)][:burst]
        pos += burst + gap
    t = np.arange(samples, dtype=np.float32) / SAMPLING_RATE
    carrier = (rng.standard_normal(samples, dtype=np.float32) * 0.5
               + 0.3 * np.sin(2 * np.pi * 220 * t))
    noise = rng.standard_normal(samples, dtype=np.float32) * np.float32(1e-4)
    return envelope * carrier + noise
