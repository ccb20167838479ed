"""Ragged segment ops (counterpart of ``aat_tpu/ops/ragged.py``): dense
segment materialization and masked pooling.

The JAX package's ``windowed_gather`` (block row-gathers that dodge the
TPU's slow element gathers) is a TPU workaround and has no counterpart:
on the GPU one index gather serves every start alignment.
"""

from __future__ import annotations

import torch


def gather_slices(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """Fixed-length windows at arbitrary starts: ``x [B, L]``,
    ``starts [B, S]`` → ``[B, S, length]``. The source is right-padded by
    ``length`` zeros and starts are clipped at 0, as the JAX version's
    dynamic slices are, so a window running past the row end reads zeros."""
    b, l = x.shape
    xp = torch.nn.functional.pad(x, (0, length))
    lp = l + length
    # dynamic_slice clamps a start into [0, Lp - length]
    st = starts.to(torch.int64).clamp(0, lp - length)
    idx = st[..., None] + torch.arange(length, device=x.device)
    flat = torch.arange(b, device=x.device)[:, None, None] * lp + idx
    return xp.reshape(-1)[flat]


def materialize_segments(
    waveforms: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    out_lens: torch.Tensor,
    segment_mask: torch.Tensor,
    max_frames: int,
):
    """Gather per-segment waveform windows into a dense batch.

    Returns ``segments [B, S, max_frames]`` (samples past ``end - start``
    zeroed) and ``frame_mask [B, S, max_frames]`` bool, True on the
    ``out_lens`` prefix of valid segments (the zero-padded tail of a short
    final segment counts as data, like the reference's explicit padding).
    """
    f = torch.arange(max_frames, device=waveforms.device)
    in_data = ((f[None, None, :] < (ends - starts).to(torch.int64)[..., None])
               & segment_mask[..., None])
    gathered = gather_slices(waveforms, starts, max_frames)
    segments = torch.where(in_data, gathered, torch.zeros((), dtype=gathered.dtype,
                                                           device=gathered.device))
    frame_mask = (f[None, None, :] < out_lens.to(torch.int64)[..., None]) & segment_mask[..., None]
    return segments, frame_mask


def masked_mean(embeddings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the time axis: ``[..., T, E], [..., T] → [..., E]``."""
    m = mask.to(embeddings.dtype)[..., None]
    total = torch.sum(embeddings * m, dim=-2)
    count = torch.clamp_min(torch.sum(m, dim=-2), 1.0)
    return total / count
