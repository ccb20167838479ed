"""Print the mean and norm of saved mean-pooled segment embeddings, the
``.npy`` files of ``mean_segment_embeddings`` (counterpart of
``scripts/inspect_embeddings.py``).

Usage:
    python -m aat_tpu_torch.scripts.inspect_embeddings --embeddings <dir> [--limit N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--embeddings", default="data/audio_embeddings_mean_tokenized")
    parser.add_argument("--limit", type=int, default=10)
    args = parser.parse_args(argv)

    for name in sorted(os.listdir(args.embeddings))[: args.limit]:
        emb = np.load(os.path.join(args.embeddings, name))
        print(f"{name}: shape {emb.shape} mean {emb.mean():.6f} "
              f"norm {np.linalg.norm(emb, axis=-1).mean():.4f}")


if __name__ == "__main__":
    main()
