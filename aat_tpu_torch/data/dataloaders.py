"""Dataset loading and batch iteration (counterpart of
``aat_tpu/data/dataloaders.py``): :func:`load_hf_dataset`,
:class:`BatchIterator` (seeded shuffle per epoch, interleaved shards,
length bucketing, a prefetch thread) and :func:`build_dataloaders`.

Batches are the collators' numpy dicts; the trainer moves them to its
device. The iterator yields the JAX package's batches in the JAX package's
order for the same items, seed and epoch.
"""

from __future__ import annotations

import inspect
import logging
import queue as queue_mod
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from aat_tpu_torch.parallel.distributed import world
from aat_tpu_torch.utils import timing

logger = logging.getLogger(__name__)


def load_hf_dataset(path_or_name: str, split: Optional[str] = None):
    """A HF dataset by hub name or from disk (arrow). Needs the ``datasets``
    package and, for hub names, network access."""
    try:
        import datasets
    except ImportError as exc:
        raise RuntimeError("--dataset needs the `datasets` package, which is not "
                           "installed") from exc
    if path_or_name.endswith(".dataset") or path_or_name.endswith("/"):
        return datasets.load_from_disk(path_or_name)
    ds = datasets.load_dataset(path_or_name, "libris")
    return ds[split] if split else ds


class BatchIterator:
    """Shuffling, batching, optional background-thread prefetch.

    Counters (``utils/timing``, always on): ``data.batches`` and
    ``data.collate_s`` for every batch collated; with prefetch, on the
    consumer's side, ``data.gets``, ``data.empty_gets`` (gets that found
    the queue empty) and ``data.wait_s`` (seconds blocked in the get)."""

    def __init__(
        self,
        items: Sequence,
        collate_fn: Callable,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        prefetch: int = 2,
        is_validation: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
        bucket_key: Optional[Callable] = None,
        bucket_pool_batches: int = 50,
    ):
        self.items = items
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.is_validation = is_validation
        # length bucketing: cut the shuffled order into pools of
        # bucket_pool_batches batches, sort each pool by bucket_key, batch
        # inside the pool, then shuffle the batch order
        self.bucket_key = bucket_key
        self.bucket_pool_batches = bucket_pool_batches
        self._bucket_lengths: Optional[np.ndarray] = None
        # each shard iterates an equal, interleaved slice of one permutation
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._epoch = 0
        self._accepts_is_validation = None

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch (``DistributedSampler.set_epoch``): a
        resumed run skips completed epochs without iterating them."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.items) // self.num_shards if self.num_shards > 1 else len(self.items)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.items))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        if self.num_shards > 1:
            usable = (len(idx) // self.num_shards) * self.num_shards
            idx = idx[self.shard_index:usable:self.num_shards]
        if self.bucket_key is not None:
            if self._bucket_lengths is None:
                self._bucket_lengths = np.asarray(
                    [self.bucket_key(it) for it in self.items], np.float64)
            pool = max(self.bucket_pool_batches, 1) * self.batch_size
            sorted_pools = [
                idx[i:i + pool][np.argsort(self._bucket_lengths[idx[i:i + pool]], kind="stable")]
                for i in range(0, len(idx), pool)
            ]
            idx = np.concatenate(sorted_pools) if sorted_pools else idx
        batches = []
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            batches.append(chunk)
        if self.bucket_key is not None and self.shuffle and len(batches) > 1:
            # the same seed on every shard keeps them in lockstep
            order = np.random.default_rng(
                self.seed * 7919 + self._epoch + 1).permutation(len(batches))
            batches = [batches[int(i)] for i in order]
        return batches

    def _collate(self, chunk) -> dict:
        """The batch of ``chunk``, counted in ``data.batches`` and its host
        seconds in ``data.collate_s``."""
        start = time.perf_counter()
        items = [self.items[int(i)] for i in chunk]
        if self._accepts_is_validation is None:
            try:
                sig = inspect.signature(self.collate_fn)
                self._accepts_is_validation = "is_validation" in sig.parameters
            except (TypeError, ValueError):
                self._accepts_is_validation = False
        if self._accepts_is_validation:
            batch = self.collate_fn(items, is_validation=self.is_validation)
        else:
            batch = self.collate_fn(items)
        timing.count("data.batches")
        timing.count("data.collate_s", time.perf_counter() - start)
        return batch

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self._epoch += 1
        if self.prefetch <= 0:
            for chunk in batches:
                yield self._collate(chunk)
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            # a collate error is handed to the consumer, which raises it: a
            # swallowed one would end the epoch early without a word
            try:
                for chunk in batches:
                    q.put(self._collate(chunk))
                q.put(sentinel)
            except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
                q.put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            # each batch's get is counted (data.gets), whether it found the
            # queue empty (data.empty_gets), and the seconds it blocked
            start = time.perf_counter()
            try:
                batch, empty = q.get_nowait(), 0
            except queue_mod.Empty:
                batch, empty = q.get(), 1
            if batch is sentinel:
                break
            if isinstance(batch, BaseException):
                raise batch
            timing.count("data.gets")
            timing.count("data.empty_gets", empty)
            timing.count("data.wait_s", time.perf_counter() - start)
            yield batch


def duration_key(item) -> int:
    """Bucketing key: the raw waveform length."""
    return len(item["audio"]["array"])


def build_dataloaders(
    train_items: Sequence,
    val_items: Sequence,
    collate_fn: Callable,
    val_collate_fn: Optional[Callable] = None,
    batch_size: int = 40,
    val_batch_size: Optional[int] = None,
    few_train_samples: Optional[int] = None,
    few_val_samples: Optional[int] = None,
    seed: int = 42,
    shard_index: Optional[int] = None,
    num_shards: Optional[int] = None,
    bucket_by_duration: bool = False,
    bucket_pool_batches: int = 50,
    mesh=None,
):
    """Train and validation iterators. The shards default to ``mesh``'s data
    rank and data world (a :class:`~aat_tpu_torch.parallel.mesh.Mesh`: tp
    and sp peers read the same rows), as JAX's default to the process
    topology, and to one shard in a one-process run. In a group of several
    ranks the caller passes the mesh or the shards: the world rank is not
    the data rank under tp or sp."""
    if shard_index is None or num_shards is None:
        if mesh is not None:
            rank, size = mesh.data_rank, mesh.data_world
        elif world()[1] > 1:
            raise ValueError("build_dataloaders in a group of several ranks needs mesh= "
                             "or shard_index / num_shards")
        else:
            rank, size = 0, 1
        shard_index = rank if shard_index is None else shard_index
        num_shards = size if num_shards is None else num_shards
    if few_train_samples is not None:
        train_items = train_items[:few_train_samples]
    if few_val_samples is not None:
        val_items = val_items[:few_val_samples]
    train = BatchIterator(
        train_items, collate_fn, batch_size, shuffle=True, drop_last=True, seed=seed,
        shard_index=shard_index, num_shards=num_shards,
        bucket_key=duration_key if bucket_by_duration else None,
        bucket_pool_batches=bucket_pool_batches)
    val = BatchIterator(
        val_items, val_collate_fn or collate_fn, val_batch_size or batch_size,
        shuffle=False, drop_last=False, is_validation=True,
        shard_index=shard_index, num_shards=num_shards)
    return train, val
