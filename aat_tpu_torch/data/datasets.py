"""Precomputed-embedding datasets (counterpart of
``aat_tpu/data/datasets.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


class SegmentedEmbeddingsDataset:
    """Items carry ``segments_embeddings_path`` (an ``.npy`` file), loaded
    when the item is read."""

    def __init__(self, hf_dataset: Sequence):
        self.dataset = hf_dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        item = dict(self.dataset[idx])
        item["segments_embeddings"] = np.load(item["segments_embeddings_path"])
        return item
