"""Offline adaptive-tokenization precompute (counterpart of
``scripts/audio_tokenization.py``): each item gains a ``segment_frames``
column, the sample lengths of its segments, and the dataset is saved with
``save_to_disk``.

Two routes, with the JAX script's flags:
- the host route (default): the per-utterance host tokenizer
  (:meth:`~aat_tpu_torch.tokenizer.AdaptiveAudioTokenizer.tokenize`,
  float64 melspec);
- ``--device-batch N``: batches of N utterances through the batched
  device tokenizer
  (:meth:`~aat_tpu_torch.tokenizer.AdaptiveAudioTokenizer.tokenize_batch`)
  on ``cuda:0`` (``main(..., device=...)`` names another device), whose
  mel step is the ``csrc/mel.cu`` kernel on the card.

Usage:
    python -m aat_tpu_torch.scripts.audio_tokenization --dataset <hub-name-or-dir> \\
        --out data/libris_with_segments.dataset [--device-batch N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aat_tpu_torch.audio import AudioWaveform
from aat_tpu_torch.data.dataloaders import load_hf_dataset
from aat_tpu_torch.ops.mel import normalize_waveform
from aat_tpu_torch.runtime.device import resolve_device
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer


def segment_frames_batched(tokenizer: AdaptiveAudioTokenizer, arrays, device):
    """The device route over one batch of raw waveforms → per item the
    list of segment lengths."""
    waveforms = [normalize_waveform(np.asarray(a)) for a in arrays]
    lengths = np.array([w.shape[-1] for w in waveforms], np.int32)
    batch = np.zeros((len(waveforms), int(lengths.max())), np.float32)
    for i, w in enumerate(waveforms):
        batch[i, : w.shape[-1]] = w
    with torch.no_grad():
        out = tokenizer.tokenize_batch(torch.from_numpy(batch).to(device),
                                       torch.from_numpy(lengths).to(device))
    counts = out["num_segments"].cpu().numpy()
    lens = out["out_lens"].cpu().numpy()
    return [lens[i, : counts[i]].tolist() for i in range(len(waveforms))]


def segment_frames_host(tokenizer: AdaptiveAudioTokenizer, array) -> list:
    """The host route over one raw waveform → its segment lengths."""
    waveform = normalize_waveform(np.asarray(array))
    segments, _ = tokenizer.tokenize(AudioWaveform(waveform, 16000))
    return [s.waveform.shape[-1] for s in segments]


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", required=True)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device-batch", type=int, default=0,
                        help="if >0, run the batched device tokenizer with this batch size")
    args = parser.parse_args(argv)

    ds = load_hf_dataset(args.dataset, args.split)
    if args.limit:
        ds = ds.select(range(args.limit))
    tokenizer = AdaptiveAudioTokenizer()

    if args.device_batch > 0:
        device = resolve_device(device)

        def add_segments_batched(items):
            items["segment_frames"] = segment_frames_batched(
                tokenizer, [a["array"] for a in items["audio"]], device)
            return items

        ds = ds.map(add_segments_batched, batched=True, batch_size=args.device_batch)
    else:
        def add_segments(item):
            item["segment_frames"] = segment_frames_host(tokenizer, item["audio"]["array"])
            return item

        ds = ds.map(add_segments)
    ds.save_to_disk(args.out)


if __name__ == "__main__":
    main()
