"""Raw padded waveforms → dense segment batch, on the device (counterpart
of ``aat_tpu/data/ondevice.py``): normalization, segmentation (adaptive or
uniform) and the segment gather, with no host round trip."""

from __future__ import annotations

from typing import Optional

import torch

from aat_tpu_torch.ops.ragged import materialize_segments
from aat_tpu_torch.ops.segmentation import (
    TokenizerConfig, segment_waveforms, uniform_segment_table,
)


def segment_raw_batch(
    batch: dict,
    *,
    segmentation: str,
    max_segment_frames: int,
    max_segments: int,
    sampling_rate: int,
    tokenizer_config: Optional[TokenizerConfig] = None,
) -> dict:
    """``{"raw_waveforms" [B, L], "raw_lengths" [B]}`` → the dense segment
    keys the model consumes (``batched_segments``,
    ``segments_waveforms_mask``, ``segments_boarders_attention_mask``).
    Both normalizations (tokenizer eps 1e-6, processor eps 1e-7) derive
    from ONE mean/var computation."""
    tok_cfg = tokenizer_config or TokenizerConfig(
        max_segments=max_segments,
        max_segment_duration_milliseconds=max_segment_frames * 1000 // sampling_rate,
    )
    waveforms = batch["raw_waveforms"].to(torch.float32)
    lengths = batch["raw_lengths"].to(device=waveforms.device, dtype=torch.int64)
    valid = torch.arange(waveforms.shape[-1], device=waveforms.device)[None, :] < lengths[:, None]
    n = torch.clamp_min(lengths, 1).to(torch.float32)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=waveforms.device)

    mean = torch.sum(torch.where(valid, waveforms, zero), -1, keepdim=True) / n
    var = torch.sum(torch.where(valid, (waveforms - mean) ** 2, zero), -1, keepdim=True) / n
    tok_norm = torch.where(valid, (waveforms - mean) / (torch.sqrt(var) + 1e-6), zero)

    if segmentation == "uniform":
        table = uniform_segment_table(lengths, max_segment_frames, tok_cfg.max_segments)
    else:
        table = segment_waveforms(tok_norm, lengths, tok_cfg)

    proc_norm = torch.where(valid, (waveforms - mean) * torch.rsqrt(var + 1e-7), zero)
    segments, frame_mask = materialize_segments(
        proc_norm, table["starts"], table["ends"], table["out_lens"],
        table["segment_mask"], tok_cfg.max_segment_frames,
    )
    return {
        **batch,
        "batched_segments": segments,
        "segments_waveforms_mask": frame_mask.to(torch.float32),
        "segments_boarders_attention_mask": table["segment_mask"].to(torch.int32),
    }
