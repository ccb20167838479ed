"""Speech-to-text serving loop (counterpart of the loop in
``scripts/serve.py``): pad each utterance to whole seconds, build its
prefix on the device (segmentation → encoder → projection), admit requests
while slots are free, decode in chunks of ``run_steps``, collect results.

Callers pass a model and its parameters; the command line
``python -m aat_tpu_torch.scripts.serve --model-dir <export>`` loads them
from a ``save_pretrained`` export (``models/build.load_pretrained``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from aat_tpu_torch.data.ondevice import segment_raw_batch
from aat_tpu_torch.ops.mel import SAMPLING_RATE
from aat_tpu_torch.serving.engine import DecodeEngine, EngineConfig, encode_speech_request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    segmentation: str = "adaptive"  # 'adaptive' | 'whole' (one uniform segment)
    max_slots: int = 4
    max_new_tokens: int = 64
    max_segments: int = 64
    chunk: int = 8
    max_segment_frames: int = 4000  # 250 ms at 16 kHz (adaptive mode)
    eos_token_id: int = 2
    cache_dtype: str = "bfloat16"


def padded_length(waves: Sequence[np.ndarray]) -> int:
    """Longest utterance rounded up to whole seconds (the padding bucket)."""
    longest = max(w.size for w in waves)
    return -(-longest // SAMPLING_RATE) * SAMPLING_RATE


def build_prefix(model, params, waveform: np.ndarray, pad_to: int, config: ServeConfig):
    """One utterance → (inputs_embeds [P, H], attention_mask [P]) on the
    parameters' device. ``whole`` mode is the whole-utterance encoder:
    one uniform segment spanning the padded length."""
    device = params["lm_decoder"]["embed_tokens"]["embedding"].device
    w = np.zeros((pad_to,), np.float32)
    w[: waveform.size] = waveform
    if config.segmentation == "whole":
        seg_kw = dict(segmentation="uniform", max_segments=1, max_segment_frames=pad_to)
    else:
        seg_kw = dict(segmentation=config.segmentation, max_segments=config.max_segments,
                      max_segment_frames=config.max_segment_frames)
    batch = segment_raw_batch(
        {"raw_waveforms": torch.from_numpy(w)[None].to(device),
         "raw_lengths": torch.tensor([waveform.size], device=device)},
        sampling_rate=SAMPLING_RATE, **seg_kw)
    return encode_speech_request(model, params, batch)


def serve(model, params, waves: Sequence[np.ndarray], config: ServeConfig) -> List[np.ndarray]:
    """Decode every utterance in ``waves``; returns generated ids per
    utterance in order (eos included, pad after)."""
    pad_to = padded_length(waves)
    # the prefix length is static per padding bucket; size the engine's
    # slot layout from the first built prefix
    first = build_prefix(model, params, waves[0], pad_to, config)
    engine = DecodeEngine(params["lm_decoder"], model.lm_config, EngineConfig(
        max_slots=config.max_slots, max_prefill_len=int(first[0].shape[0]),
        max_new_tokens=config.max_new_tokens, eos_token_id=config.eos_token_id,
        cache_dtype=config.cache_dtype))

    pending = list(range(len(waves)))
    req_of_slot, results = {}, {}
    prefix_cache = {0: first}

    def submit_next():
        while pending and engine.free_slots:
            i = pending[0]
            embeds, mask = prefix_cache.pop(i, None) or build_prefix(
                model, params, waves[i], pad_to, config)
            slot = engine.submit(embeds, mask)
            req_of_slot[slot] = pending.pop(0)

    submit_next()
    while len(results) < len(waves):
        for slot in engine.run_steps(config.chunk):
            results[req_of_slot.pop(slot)] = engine.result(slot)
            submit_next()
    return [results[i] for i in range(len(waves))]
