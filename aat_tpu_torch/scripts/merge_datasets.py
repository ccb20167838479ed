"""Concatenate dataset shards saved with ``save_to_disk`` (counterpart of
``scripts/merge_datasets.py``). Needs the ``datasets`` package.

Usage:
    python -m aat_tpu_torch.scripts.merge_datasets --shards a.dataset b.dataset ... \\
        --out merged.dataset
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--shards", nargs="+", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    import datasets

    shards = [datasets.load_from_disk(p) for p in args.shards]
    datasets.concatenate_datasets(shards).save_to_disk(args.out)


if __name__ == "__main__":
    main()
