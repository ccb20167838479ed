"""Attach word alignments to a tokenized-segments dataset (counterpart of
``scripts/reduce_seq_len.py``): zip it, item for item (the ids must
agree), with the ``words`` / ``word_start`` / ``word_end`` columns of an
alignment dataset, so the collator can make word-aligned ``n_words``
crops, then save it.

``--alignments`` is a hub name, streamed as in the JAX script (it needs
the network), or a local directory written by ``save_to_disk`` (a
``DatasetDict`` gives its ``--split``).

Usage:
    python -m aat_tpu_torch.scripts.reduce_seq_len --segments <dir> \\
        --alignments nguyenvulebinh/asr-alignment --out <dir>
"""

from __future__ import annotations

import argparse
import os

from aat_tpu_torch.data.dataloaders import load_hf_dataset


def load_alignments(name_or_dir: str, split: str):
    """The alignment items: a local ``save_to_disk`` directory, or the hub
    dataset's ``libris`` config, streamed."""
    import datasets

    if os.path.isdir(name_or_dir):
        ds = datasets.load_from_disk(name_or_dir)
        return ds[split] if isinstance(ds, datasets.DatasetDict) else ds
    return datasets.load_dataset(name_or_dir, "libris", streaming=True)[split]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--segments", required=True)
    parser.add_argument("--alignments", default="nguyenvulebinh/asr-alignment")
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    segments_ds = load_hf_dataset(args.segments)
    aligned = load_alignments(args.alignments, args.split)

    words, word_start, word_end = [], [], []
    for item, alignment in zip(segments_ds, aligned):
        if item["id"] != alignment["id"]:
            raise ValueError(f"item {item['id']!r} meets alignment {alignment['id']!r}")
        words.append(alignment["words"])
        word_start.append(alignment["word_start"])
        word_end.append(alignment["word_end"])

    segments_ds = segments_ds.add_column("words", words)
    segments_ds = segments_ds.add_column("word_start", word_start)
    segments_ds = segments_ds.add_column("word_end", word_end)
    segments_ds.save_to_disk(args.out)


if __name__ == "__main__":
    main()
