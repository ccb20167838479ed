"""Adaptive amplitude segmentation, device path (counterpart of
``aat_tpu/ops/segmentation.py``).

melspec → smoothed amplitude → epsilon-strict minima → boundary compaction
→ merge-forward (pointer doubling) / split of over-long spans → a dense
``[B, S_max]`` (start, end, out_len, valid) table. Same semantics and the
same integer results as the JAX ``segment_waveforms``; the table is split
from the melspec (:func:`segment_table_from_melspec`) so a caller can
build it from any melspec of the same batch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from aat_tpu_torch.ops import mel as mel_ops

EPS = 1e-5  # fp32 comparator epsilon of the reference


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """The reference tokenizer's settings plus the device path's fixed
    capacities (same fields and defaults as the JAX package's)."""

    running_mean_points: int = 12
    min_segment_duration_milliseconds: int = 125
    max_segment_duration_milliseconds: int = 1500
    n_fft: int = 400
    hop_length: int = 160
    num_mel_filters: int = 64
    sampling_rate: int = 16000
    max_amplitude_for_minima: float = 15.0
    max_segments: int = 304
    max_minima: int = 512

    @property
    def min_segment_frames(self) -> int:
        return int(self.min_segment_duration_milliseconds * self.sampling_rate / 1000)

    @property
    def max_segment_frames(self) -> int:
        return int(self.max_segment_duration_milliseconds * self.sampling_rate / 1000)

    @property
    def start_granularity(self) -> int:
        """gcd of hop and the min/max segment frames (40 at defaults)."""
        return math.gcd(math.gcd(self.hop_length, self.min_segment_frames),
                        self.max_segment_frames)


def smoothed_amplitude(melspec: torch.Tensor, running_mean_points: int = 12) -> torch.Tensor:
    """``[..., n_mels, T]`` → ``[..., T - n]``: the direct n-term windowed
    mean of ``-10 * mean(melspec)``, summed term by term in the JAX
    package's order (a cumsum or conv rounds differently, and the 1e-5
    comparator downstream can see it)."""
    amplitude = -10.0 * torch.mean(melspec, dim=-2)
    n = running_mean_points
    t = amplitude.shape[-1]
    acc = amplitude[..., 1 : t - n + 1]
    for j in range(2, n + 1):
        acc = acc + amplitude[..., j : t - n + j]
    return acc / float(n)


def minima_mask(smoothed: torch.Tensor, valid_length: torch.Tensor,
                max_amplitude: float = 15.0) -> torch.Tensor:
    """Epsilon-strict local-maxima mask over the padded smoothed curve;
    only interior points of each row's valid region qualify."""
    x = smoothed
    ts = x.shape[-1]
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    is_max = (x > right + EPS) & (x > left + EPS) & (x > max_amplitude)
    pos = torch.arange(ts, device=x.device)
    interior = (pos >= 1) & (pos[None, :] < valid_length[..., None] - 1)
    return is_max & interior


def _merge_forward_orbit(bvals: torch.Tensor, min_f: int, k_max: int) -> torch.Tensor:
    """Mark the boundaries the greedy merge-forward walk keeps.

    Per row, the walk is the orbit of the first boundary >= min_f under
    ``next[i] = first j with boundary[j] >= boundary[i] + min_f``; the
    orbit is marked in O(log K) pointer-doubling rounds. Node ``k_max`` is
    the virtual "walk ended" node that every overshooting jump lands on."""
    b = bvals.shape[0]
    dev = bvals.device
    nxt = torch.searchsorted(bvals, bvals + min_f, side="left").clamp(max=k_max)
    jump = torch.cat([nxt, torch.full((b, 1), k_max, dtype=nxt.dtype, device=dev)], dim=1)
    first = torch.searchsorted(
        bvals, torch.full((b, 1), min_f, dtype=bvals.dtype, device=dev), side="left")
    mark = torch.zeros((b, k_max + 1), dtype=torch.int32, device=dev)
    mark.scatter_(1, first.clamp(max=k_max), 1)
    rounds = max(int(np.ceil(np.log2(k_max + 1))), 1)
    for _ in range(rounds):
        propagated = torch.zeros_like(mark).scatter_reduce(
            1, jump, mark, reduce="amax", include_self=True)
        mark = mark | propagated
        jump = torch.gather(jump, 1, jump)
    return mark[:, :k_max] > 0


def segment_table_from_melspec(melspec: torch.Tensor, lengths: torch.Tensor,
                               config: TokenizerConfig = TokenizerConfig()) -> dict:
    """Segment tables from a ragged batch's melspec ``[B, n_mels, T_max]``
    and its ``[B]`` sample lengths (everything ``segment_waveforms`` does
    after the mel step)."""
    dev = melspec.device
    b = melspec.shape[0]
    hop = config.hop_length
    n = config.running_mean_points
    s_max = config.max_segments
    k_max = config.max_minima
    min_f, max_f = config.min_segment_frames, config.max_segment_frames
    lengths = lengths.to(device=dev, dtype=torch.int64)

    t_valid = lengths // hop + 1
    smoothed = smoothed_amplitude(melspec, n)
    mask = minima_mask(smoothed, t_valid - n, config.max_amplitude_for_minima)

    # Compact minima positions into [B, K_max] ascending boundary slots. The
    # scatter writes dropped entries into a spare column that is sliced off.
    ts = mask.shape[-1]
    pos = torch.arange(ts, device=dev).expand(b, ts)
    slot = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    num_minima = torch.clamp(mask.sum(-1), max=k_max - 1)
    boundaries = torch.full((b, k_max + 1), np.iinfo(np.int32).max,
                            dtype=torch.int64, device=dev)
    scatter_slot = torch.where(mask & (slot < k_max - 1), slot,
                               torch.full_like(slot, k_max))
    boundaries = boundaries.scatter(1, scatter_slot, pos * hop)[:, :k_max]
    # final boundary: the waveform end
    boundaries = boundaries.scatter(1, num_minima[:, None], lengths[:, None])
    n_boundaries = num_minima + 1

    # ---- Phase A: merge-forward via pointer doubling ----
    slot_ids = torch.arange(k_max, device=dev)[None, :]
    slot_valid = slot_ids < n_boundaries[:, None]
    bvals = torch.where(slot_valid, boundaries, torch.full_like(boundaries, 2**30))
    span_keep = _merge_forward_orbit(bvals, min_f, k_max) & slot_valid
    span_ends = torch.where(span_keep, boundaries, 0)
    prev_kept = torch.cummax(torch.where(span_keep, boundaries, 0), dim=-1).values
    span_starts = torch.where(
        span_keep,
        torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                   prev_kept[:, :-1]], dim=1),
        0)
    prev_final = prev_kept.max(dim=-1).values

    has_tail = prev_final != lengths
    tail_len = lengths - prev_final

    # ---- Phase B: split of over-long spans ----
    span_len = torch.where(span_keep, span_ends - span_starts, 0)
    k = span_len // max_f
    gap = span_len - k * max_f
    n_pieces = torch.where(
        ~span_keep, 0,
        torch.where(span_len <= max_f, 1, torch.where(gap == 0, k, k + 1)))
    piece_offset = torch.cumsum(n_pieces, dim=-1) - n_pieces
    total_pieces = n_pieces.sum(-1)

    out_slots = torch.arange(s_max, device=dev)[None, :].expand(b, s_max)
    cum_end = torch.cumsum(n_pieces, dim=-1)
    span_idx = torch.searchsorted(cum_end, out_slots.contiguous(), right=True)
    span_idx = span_idx.clamp(max=k_max - 1)

    def take(a):
        return torch.gather(a, 1, span_idx)

    s_start, s_len, s_gap = take(span_starts), take(span_len), take(gap)
    s_np, s_off = take(n_pieces), take(piece_offset)
    piece = out_slots - s_off

    shifted = (s_gap > 0) & (s_gap < min_f) & (s_len > max_f)
    is_last = piece == s_np - 1
    is_second_last = piece == s_np - 2
    piece_start = torch.where(shifted & is_last, s_start + s_len - min_f,
                              s_start + piece * max_f)
    piece_end = torch.where(is_last, s_start + s_len, s_start + (piece + 1) * max_f)
    piece_end = torch.where(shifted & is_second_last, s_start + s_len - min_f, piece_end)

    in_range = out_slots < total_pieces[:, None]
    starts = torch.where(in_range, piece_start, 0)
    ends = torch.where(in_range, piece_end, 0)

    # the tail segment sits at slot total_pieces when present
    tail_slot = torch.clamp(total_pieces, max=s_max - 1)
    at_tail = has_tail[:, None] & (out_slots == tail_slot[:, None])

    def set_tail(arr, vals):
        return torch.where(at_tail, vals[:, None], arr)

    starts = set_tail(starts, prev_final)
    ends = set_tail(ends, lengths)
    seg_mask = in_range | at_tail
    out_lens = torch.where(seg_mask, ends - starts, 0)
    out_lens = set_tail(out_lens, torch.clamp(tail_len, min=min_f))
    num_segments = total_pieces + has_tail.to(torch.int64)

    return {
        "starts": starts.to(torch.int32),
        "ends": ends.to(torch.int32),
        "out_lens": out_lens.to(torch.int32),
        "segment_mask": seg_mask,
        "num_segments": num_segments.to(torch.int32),
    }


def segment_waveforms(waveforms: torch.Tensor, lengths: torch.Tensor,
                      config: TokenizerConfig = TokenizerConfig()) -> dict:
    """Adaptive segmentation of a padded ``[B, L_max]`` normalized batch
    with ``[B]`` sample lengths. Returns the JAX package's keys:
    melspec [B, n_mels, T_max], starts/ends/out_lens [B, S_max] int32,
    segment_mask [B, S_max] bool, num_segments [B] int32."""
    mel_settings = (config.n_fft, config.hop_length, config.num_mel_filters,
                    config.sampling_rate)
    if mel_settings != (mel_ops.N_FFT, mel_ops.HOP_LENGTH, mel_ops.N_MELS,
                        mel_ops.SAMPLING_RATE):
        raise ValueError(f"the mel front end runs the reference's (n_fft, hop, "
                         f"mels, rate) = (400, 160, 64, 16000), got {mel_settings}")
    melspec = mel_ops.log_mel_spectrogram_ragged(waveforms, lengths)
    return {"melspec": melspec, **segment_table_from_melspec(melspec, lengths, config)}


def uniform_segment_table(lengths: torch.Tensor, frames_per_segment: int,
                          max_segments: int) -> dict:
    """Fixed-size segments with a remainder tail (same schema as
    :func:`segment_waveforms` minus the melspec)."""
    lengths = lengths.to(torch.int64)
    full = lengths // frames_per_segment
    rem = lengths - full * frames_per_segment
    num_segments = full + (rem > 0).to(torch.int64)
    slots = torch.arange(max_segments, device=lengths.device)[None, :]
    seg_mask = slots < num_segments[:, None]
    starts = torch.where(seg_mask, slots * frames_per_segment, 0)
    ends = torch.minimum(starts + frames_per_segment, lengths[:, None])
    ends = torch.where(seg_mask, ends, 0)
    out_lens = torch.where(seg_mask, ends - starts, 0)
    return {
        "starts": starts.to(torch.int32),
        "ends": ends.to(torch.int32),
        "out_lens": out_lens.to(torch.int32),
        "segment_mask": seg_mask,
        "num_segments": num_segments.to(torch.int32),
    }
