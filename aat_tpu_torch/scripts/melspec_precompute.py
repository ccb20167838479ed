"""Offline mel-spectrogram precompute (counterpart of
``scripts/melspec_precompute.py``).

For each dataset item: mean/std-normalize the waveform, compute the host
float64 log-mel spectrogram
(:func:`~aat_tpu_torch.ops.mel.log_mel_spectrogram_exact`, ``[64, T]``
float32) and save it as ``<out>/<id>.npy``; an existing file is skipped.
The collators read these files as their melspec cache.

Usage:
    python -m aat_tpu_torch.scripts.melspec_precompute --dataset <hub-name-or-dir> \\
        --out data/libris_melspectrograms [--limit N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from aat_tpu_torch.data.dataloaders import load_hf_dataset
from aat_tpu_torch.ops.mel import log_mel_spectrogram_exact, normalize_waveform


def process_item(item, out_dir: str) -> None:
    path = os.path.join(out_dir, str(item["id"]) + ".npy")
    if os.path.exists(path):
        return
    waveform = np.asarray(item["audio"]["array"])
    np.save(path, log_mel_spectrogram_exact(normalize_waveform(waveform)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", default="data/libris_melspectrograms")
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    ds = load_hf_dataset(args.dataset, args.split)
    if args.limit:
        ds = ds.select(range(args.limit))
    os.makedirs(args.out, exist_ok=True)
    for item in ds:
        process_item(item, args.out)


if __name__ == "__main__":
    main()
