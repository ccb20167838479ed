"""Segment-count statistics of a tokenized dataset, one with the
``segment_frames`` column that ``audio_tokenization`` adds (counterpart of
``scripts/dataset_info.py``).

Usage:
    python -m aat_tpu_torch.scripts.dataset_info --dataset <dir>
"""

from __future__ import annotations

import argparse

import numpy as np

from aat_tpu_torch.data.dataloaders import load_hf_dataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    args = parser.parse_args(argv)

    ds = load_hf_dataset(args.dataset)
    counts = np.array([len(item["segment_frames"]) for item in ds])
    print(f"items: {len(counts)}")
    print(f"segments/utt: mean {counts.mean():.2f} p50 {np.percentile(counts, 50):.0f} "
          f"p95 {np.percentile(counts, 95):.0f} max {counts.max()}")
    durations = np.array([sum(item["segment_frames"]) / 16000 for item in ds])
    print(f"duration_s: mean {durations.mean():.2f} total {durations.sum():.1f}")


if __name__ == "__main__":
    main()
