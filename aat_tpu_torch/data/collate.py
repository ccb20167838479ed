"""Batch collators (counterpart of ``aat_tpu/data/collate.py``), host
numpy, equal to the JAX package's element for element on the same items
and seed.

- :class:`TokenizedAudioWaveformCollator`: per item the melspec (an
  ``.npy`` cache read memory-mapped, or computed), uniform or adaptive
  segment boundaries, the word-aligned ``n_words`` random crop with a
  5-frame melspec overlap, the prompt prefix and BOS/EOS text, then the
  waveforms normalized and laid out as dense ``[bs, segments,
  max_segment_frames]`` segments with masks, text and segment counts
  padded up to bucket multiples.
- :class:`NoSegmentationAudioWaveformCollator`: the whole-utterance
  variant.

Every random draw comes from one ``np.random.default_rng(seed)`` per
collator in the JAX package's order: the batch's ``n_words``, then per
item the noise, the crop and the prefix. The melspec batches of the
EfficientNet encoder are not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from aat_tpu_torch.audio import AudioWaveform
from aat_tpu_torch.ops import mel as mel_ops
from aat_tpu_torch.runtime import host_ops
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer

# prompt prefixes (data strings of the reference's augmentation)
PREFIXES = [
    "The audio transcription states:",
    "According to the audio transcript:",
    "As per the audio transcription:",
    "In the audio recording it is said:",
    "Based on the audio script:",
    "Per the audio record:",
    "From the audio file it can be heard:",
    "What the audio text conveys is:",
    "Transcribed from the audio:",
    "Listening to the recording reveals:",
]


def zero_mean_unit_var_pad(waveforms: List[np.ndarray], padding_value: float = 0.0):
    """HF Wav2Vec2 feature-extractor semantics: per-utterance zero-mean /
    unit-variance over the valid samples, then right-pad to the batch max
    → (f32 [B, L], int64 mask)."""
    max_len = max(w.shape[-1] for w in waveforms)
    bs = len(waveforms)
    out = np.full((bs, max_len), padding_value, dtype=np.float32)
    mask = np.zeros((bs, max_len), dtype=np.int64)
    for i, w in enumerate(waveforms):
        n = w.shape[-1]
        out[i, :n] = (w - w.mean()) / np.sqrt(w.var() + 1e-7)
        mask[i, :n] = 1
    return out, mask


def pad_waveforms(waveforms: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """Raw right padding without normalization."""
    max_len = max(w.shape[-1] for w in waveforms)
    bs = len(waveforms)
    batched = np.zeros((bs, max_len), dtype=np.float32)
    mask = np.zeros((bs, max_len), dtype=np.int64)
    for i, w in enumerate(waveforms):
        batched[i, : w.shape[-1]] = w
        mask[i, : w.shape[-1]] = 1
    return {"input_values": batched, "attention_mask": mask}


def uniform_boundaries(waveform_length: int, frames_per_segment: int) -> np.ndarray:
    """Cumulative boundaries of segments of ``frames_per_segment`` samples,
    the last one shorter (``aat_tpu/ops/segmentation.uniform_boundaries``)."""
    num_segments = waveform_length // frames_per_segment
    sizes = [frames_per_segment] * num_segments
    if waveform_length % frames_per_segment > 0:
        sizes.append(waveform_length - sum(sizes))
    return np.cumsum(np.array(sizes, dtype=np.int64))


def _noisy_waveform(item, rng: np.random.Generator, noise_augmentation: bool) -> np.ndarray:
    """The item's waveform as float64, plus ``rand(n) * randint(1, 50) /
    1000`` when augmenting (two draws, in this order)."""
    waveform = np.asarray(item["audio"]["array"], dtype=np.float64)
    if noise_augmentation:
        waveform = waveform + rng.random(waveform.shape[-1]) * (int(rng.integers(1, 51)) / 1000)
    return waveform


def _check_rate(item, sampling_rate: int):
    rate = item["audio"]["sampling_rate"]
    if rate != sampling_rate:
        raise ValueError(f"item {item.get('id')}: sampling rate {rate}, expected {sampling_rate}")


def _with_prefix(words, rng: np.random.Generator, add_prefix: bool):
    """(prefix, text): a random prompt prefix drawn when ``add_prefix``."""
    text = " ".join(words)
    prefix = ""
    if add_prefix:
        prefix = PREFIXES[int(rng.integers(0, len(PREFIXES)))] + " "
        text = prefix + text
    return prefix, text


def _bucket_pad(ids, mask, multiple):
    if multiple <= 1:
        return ids, mask
    width = -(-ids.shape[1] // multiple) * multiple
    pad = ((0, 0), (0, width - ids.shape[1]))
    return np.pad(ids, pad), np.pad(mask, pad)


def _tokenize_texts(tokenizer, texts, prefixes, bucket: int = 1) -> Dict[str, np.ndarray]:
    """Captions and prefixes through the tokenizer, padded to a multiple of
    ``bucket``."""
    tokenized = tokenizer(texts, padding=True)
    ids, mask = _bucket_pad(np.asarray(tokenized["input_ids"]),
                            np.asarray(tokenized["attention_mask"]), bucket)
    tokenized_prefix = tokenizer(prefixes, padding=True)
    pids, pmask = _bucket_pad(np.asarray(tokenized_prefix["input_ids"]),
                              np.asarray(tokenized_prefix["attention_mask"]), bucket)
    return {"input_ids": ids, "attention_mask": mask, "input_ids_attention_mask": mask,
            "prefix_input_ids": pids, "prefix_attention_mask": pmask}


class TokenizedAudioWaveformCollator:
    def __init__(
        self,
        audio_encoder_type: str,
        segmentation: str,
        audio_tokenizer: AdaptiveAudioTokenizer,
        tokenizer,
        n_words: Optional[int] = None,
        noise_augmentation: bool = False,
        uniform_segmentation_frames_per_segment: Optional[int] = None,
        add_prefix: bool = True,
        melspec_cache_dir: Optional[str] = None,
        max_segment_waveform_frames: Optional[int] = None,
        seed: int = 0,
        bucket_text: int = 16,
        bucket_segments: int = 8,
    ):
        if segmentation not in ("uniform", "adaptive"):
            raise ValueError(f"segmentation must be uniform or adaptive, not {segmentation!r}")
        if audio_encoder_type == "efficient_net":
            raise NotImplementedError("EfficientNet melspec batches are not ported yet "
                                      "(ROADMAP Queue 1 item 7)")
        self.audio_encoder_type = audio_encoder_type
        self.segmentation = segmentation
        self.audio_tokenizer = audio_tokenizer
        self.tokenizer = tokenizer
        self.n_words = n_words
        self.noise_augmentation = noise_augmentation
        self.uniform_segmentation_frames_per_segment = uniform_segmentation_frames_per_segment
        self.add_prefix = add_prefix
        self.melspec_cache_dir = melspec_cache_dir
        self.sampling_rate = audio_tokenizer.sampling_rate
        self.max_segment_waveform_frames = (max_segment_waveform_frames
                                            or audio_tokenizer.max_segment_frames)
        self.rng = np.random.default_rng(seed)
        # padded text lengths and segment counts round up to these multiples
        self.bucket_text = bucket_text
        self.bucket_segments = bucket_segments

    def _melspec_for(self, item, waveform):
        if self.melspec_cache_dir is not None:
            path = os.path.join(self.melspec_cache_dir, str(item["id"]) + ".npy")
            if os.path.exists(path):
                try:
                    # memory-mapped: the crop and the segments read windows;
                    # nothing downstream writes to it
                    return np.load(path, mmap_mode="r")
                except (OSError, ValueError):  # an unreadable cache entry is recomputed
                    pass
        return self.audio_tokenizer.get_melspec(mel_ops.normalize_waveform(waveform))

    def _boundaries_for(self, waveform, melspec):
        n = waveform.shape[-1]
        if self.segmentation == "uniform":
            return uniform_boundaries(n, self.uniform_segmentation_frames_per_segment), melspec
        normed = mel_ops.normalize_waveform(waveform)
        segments, melspec = self.audio_tokenizer.tokenize(
            AudioWaveform(normed, self.sampling_rate), melspec=melspec)
        lengths = np.array([s.waveform.shape[-1] for s in segments])
        return lengths.cumsum(), melspec

    def _crop_to_words(self, item, waveform, melspec, boundaries, n_words):
        """Word-aligned random crop to ``n_words`` words, widened to whole
        segments and by 5 melspec frames each side → (waveform, melspec,
        boundaries, words)."""
        words = list(item["words"])
        if n_words is None or len(words) <= n_words:
            return waveform, melspec, boundaries, words

        hop = self.audio_tokenizer.hop_length
        rmp = self.audio_tokenizer.running_mean_points
        start_word = int(self.rng.integers(0, len(words) - n_words + 1))
        end_word = start_word + n_words
        words = words[start_word:end_word]

        start_frame = int(item["word_start"][start_word] * self.sampling_rate)
        end_frame = int(item["word_end"][end_word - 1] * self.sampling_rate)

        with_zero = np.insert(boundaries, 0, 0)
        start_seg = max(int(np.searchsorted(with_zero, start_frame)) - 1, 0)
        end_seg = int(np.searchsorted(with_zero, end_frame, side="right"))
        if end_seg >= len(with_zero):
            raise ValueError(f"item {item.get('id')}: word end {end_frame} lies past the "
                             f"last segment boundary {int(with_zero[-1])}")

        seg_start_sample = int(with_zero[start_seg])
        seg_end_sample = int(with_zero[end_seg])
        boundaries = (with_zero[start_seg: end_seg + 1] - seg_start_sample)[1:]

        overlap = 5  # melspec frames
        wf_overlap = overlap * hop
        crop_start = max(0, seg_start_sample - wf_overlap)
        crop_end = min(seg_end_sample + wf_overlap, waveform.shape[-1])
        waveform = waveform[crop_start:crop_end]

        mel_start = max(0, crop_start // hop - rmp - overlap)
        mel_end = min(crop_end // hop + overlap, melspec.shape[-1])
        return waveform, melspec[:, mel_start:mel_end], boundaries, words

    def __call__(self, items, is_validation: bool = False) -> Dict[str, np.ndarray]:
        tokenizer = self.tokenizer
        bos = tokenizer.decode([tokenizer.bos_token_id])
        eos = tokenizer.decode([tokenizer.eos_token_id])

        n_words = None
        if self.n_words is not None and not is_validation:
            n_words = int(self.rng.integers(5, self.n_words + 1))

        texts, prefixes = [], []
        all_boundaries: List[np.ndarray] = []
        waveforms: List[np.ndarray] = []
        max_frame_lens: List[int] = []
        for item in items:
            _check_rate(item, self.sampling_rate)
            waveform = _noisy_waveform(item, self.rng, self.noise_augmentation)
            melspec = self._melspec_for(item, waveform)
            boundaries, melspec = self._boundaries_for(waveform, melspec)
            raw_lengths = np.diff(np.insert(boundaries, 0, 0))
            waveform, melspec, boundaries, words = self._crop_to_words(
                item, waveform, melspec, boundaries, n_words)
            prefix, text = _with_prefix(words, self.rng, self.add_prefix)
            prefixes.append(bos + prefix)
            texts.append(bos + text + eos)
            waveforms.append(waveform)
            all_boundaries.append(np.asarray(boundaries))
            max_frame_lens.append(int(raw_lengths.max()))

        result = _tokenize_texts(tokenizer, texts, prefixes, self.bucket_text)

        bs = len(items)
        max_n_bounds = max(len(b) for b in all_boundaries)
        if self.bucket_segments > 1:
            max_n_bounds = -(-max_n_bounds // self.bucket_segments) * self.bucket_segments
        boarders = np.zeros((bs, max_n_bounds), dtype=np.int64)
        boarders_mask = np.zeros((bs, max_n_bounds), dtype=np.int64)
        for i, b in enumerate(all_boundaries):
            boarders[i, : len(b)] = b
            boarders_mask[i, : len(b)] = 1
        result["segments_boarders_padded"] = boarders
        result["segments_boarders_attention_mask"] = boarders_mask
        result["segments_max_frame_len"] = np.asarray(max_frame_lens)
        result["segments_count"] = max_n_bounds

        # per-row zero-mean/unit-var, then the dense segment batch
        max_frames = self.max_segment_waveform_frames
        normed, _ = host_ops.normalize_pad(waveforms)
        starts = np.concatenate([np.zeros((bs, 1), np.int64), boarders[:, :-1]], axis=1)
        seg_valid = boarders_mask.astype(bool) & (boarders > starts)
        seg_lens = np.where(seg_valid, boarders - starts, 0)
        batched = np.empty((bs, max_n_bounds, max_frames), np.float32)
        masks = np.empty((bs, max_n_bounds, max_frames), np.float32)
        for i in range(bs):
            batched[i], masks[i] = host_ops.assemble_segments(
                normed[i], starts[i], starts[i] + seg_lens[i], seg_lens[i], max_frames)
        result["batched_segments"] = batched
        result["segments_waveforms_mask"] = masks
        result["batched_segments_melspectrograms"] = None
        return result


class NoSegmentationAudioWaveformCollator:
    """Whole-utterance collator: normalized, padded waveforms and the
    captions."""

    def __init__(self, tokenizer, sampling_rate: int = 16000, add_prefix: bool = True,
                 noise_augmentation: bool = True, seed: int = 0):
        self.tokenizer = tokenizer
        self.sampling_rate = sampling_rate
        self.add_prefix = add_prefix
        self.noise_augmentation = noise_augmentation
        self.rng = np.random.default_rng(seed)

    def __call__(self, items) -> Dict[str, np.ndarray]:
        tokenizer = self.tokenizer
        bos = tokenizer.decode([tokenizer.bos_token_id])
        eos = tokenizer.decode([tokenizer.eos_token_id])

        texts, prefixes, waveforms = [], [], []
        for item in items:
            waveforms.append(_noisy_waveform(item, self.rng, self.noise_augmentation))
            prefix, text = _with_prefix(item["words"], self.rng, self.add_prefix)
            prefixes.append(bos + prefix)
            texts.append(bos + text + eos)

        result = _tokenize_texts(tokenizer, texts, prefixes)
        normed, mask = zero_mean_unit_var_pad(waveforms)
        result["waveforms"] = normed
        result["waveforms_attention_mask"] = mask
        return result
