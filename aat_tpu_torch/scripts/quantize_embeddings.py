"""Codebook quantization of segment embeddings (counterpart of
``scripts/quantize_embeddings.py``): EMA k-means over the mean-pooled
segment embeddings of every ``.npy`` file (``[1, S, E]``), with a codebook
seeded from the data, then discrete audio-token ids per file.

Each iteration assigns every embedding to its nearest code
(:func:`aat_tpu_torch.ops.vq.nearest_codebook`: the hand-written kernel
``csrc/vq.cu`` on a GPU) and moves the codes by one EMA step. With fewer
embeddings than codes, the codebook is padded with copies of its first
row; those exact ties go to the lowest code id.

Usage:
    python -m aat_tpu_torch.scripts.quantize_embeddings --embeddings <dir of .npy [1,S,E]> \\
        --out <dir> [--codes 1024] [--iters 50]

Writes ``codebook.npy`` and ``<name>.tokens.npy`` (int32) per input file.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from aat_tpu_torch.ops import vq
from aat_tpu_torch.scripts import resolve_device


def seed_codebook(embeddings: torch.Tensor, codes: int) -> vq.VQState:
    """``codes`` distinct data rows drawn by ``default_rng(0)``, padded with
    copies of the first when there are fewer rows than codes."""
    n = embeddings.shape[0]
    seed_idx = np.random.default_rng(0).choice(n, size=min(codes, n), replace=False)
    codebook = embeddings[torch.from_numpy(seed_idx).to(embeddings.device)]
    if codebook.shape[0] < codes:
        codebook = torch.cat([codebook, codebook[:1].repeat(codes - codebook.shape[0], 1)])
    ones = torch.ones((codes,), dtype=torch.float32, device=embeddings.device)
    return vq.VQState(codebook, ones, codebook)


def train_codebook(embeddings: torch.Tensor, codes: int, iters: int, decay: float,
                   log: Callable[[str], None] = print) -> vq.VQState:
    """EMA k-means from :func:`seed_codebook`; logs the reconstruction MSE
    and the codes in use after the first iteration and every tenth."""
    state = seed_codebook(embeddings, codes)
    for it in range(iters):
        idx, quant = vq.nearest_codebook(embeddings, state.codebook)
        state = vq.vq_ema_update(state, embeddings, idx, decay=decay)
        if (it + 1) % 10 == 0 or it == 0:
            mse = float(((embeddings - quant) ** 2).sum(-1).mean())
            used = int((torch.bincount(idx.long(), minlength=codes) > 0).sum())
            log(f"iter {it + 1}: reconstruction MSE {mse:.4f}, codes used {used}/{codes}")
    return state


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--embeddings", default="data/audio_embeddings_mean_tokenized")
    parser.add_argument("--out", default="data/audio_tokens")
    parser.add_argument("--codes", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--decay", type=float, default=0.8)
    parser.add_argument("--use-pallas", action="store_true", default=True,
                        help="accepted for the JAX command line; on a GPU the "
                             "assignment always runs the vq kernel")
    args = parser.parse_args(argv)
    device = resolve_device(device)

    files = sorted(f for f in os.listdir(args.embeddings) if f.endswith(".npy"))
    if not files:
        raise SystemExit(f"no .npy embeddings under {args.embeddings}")
    per_file = []
    for name in files:
        emb = np.load(os.path.join(args.embeddings, name))  # [1, S, E]
        per_file.append(np.asarray(emb, np.float32).reshape(-1, emb.shape[-1]))
    embeddings = torch.from_numpy(np.concatenate(per_file)).to(device)
    print(f"{len(files)} files, {embeddings.shape[0]} segment embeddings, "
          f"dim {embeddings.shape[1]}")

    state = train_codebook(embeddings, args.codes, args.iters, args.decay)

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "codebook.npy"), state.codebook.cpu().numpy())
    for name, emb in zip(files, per_file):
        ids, _ = vq.nearest_codebook(torch.from_numpy(emb).to(device), state.codebook)
        np.save(os.path.join(args.out, name.replace(".npy", ".tokens.npy")),
                ids.cpu().numpy().astype(np.int32))
    print(f"wrote codebook + {len(files)} token files to {args.out}")


if __name__ == "__main__":
    main()
