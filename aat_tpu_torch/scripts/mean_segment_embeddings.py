"""Mean-pooled segment embeddings (counterpart of
``scripts/mean_segment_embeddings.py``): for each ``<id>.npz`` of
per-segment frame embeddings, the mean over frames of every segment,
concatenated in segment order into ``[1, n_segments, E]`` and saved as
``<id>.npy``. Host numpy; no device.

Usage:
    python -m aat_tpu_torch.scripts.mean_segment_embeddings \\
        --embeddings data/audio_segments_embeddings \\
        --out data/audio_embeddings_mean_tokenized
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--embeddings", default="data/audio_segments_embeddings")
    parser.add_argument("--out", default="data/audio_embeddings_mean_tokenized")
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for name in sorted(os.listdir(args.embeddings)):
        if not name.endswith(".npz"):
            continue
        out_path = os.path.join(args.out, name.replace(".npz", ".npy"))
        if os.path.exists(out_path):
            continue
        data = np.load(os.path.join(args.embeddings, name))
        keys = sorted(data.files, key=lambda k: int(k.split("_")[1]))
        means = [data[k].mean(axis=0, keepdims=True) for k in keys]  # [1, E] each
        np.save(out_path, np.concatenate([m[None, :, :] for m in means], axis=1))


if __name__ == "__main__":
    main()
