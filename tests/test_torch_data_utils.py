"""The port's data utilities against the JAX package's: ``BatchIterator``
yields the same index batches in the same order under shuffle, epochs
(auto and ``set_epoch``), shards, drop_last and length bucketing;
``build_dataloaders``; the prefetch thread hands collate errors to the
consumer; ``load_hf_dataset`` needs ``datasets``; and
``SegmentedEmbeddingsDataset``, ``JsonlTracker`` and ``RecordTimings``.
Mirrors ``tests/test_data_utils.py``."""

import json
import sys
import time

import numpy as np
import pytest

from aat_tpu.data import dataloaders as jdl
from aat_tpu.data.datasets import SegmentedEmbeddingsDataset as JDataset
from aat_tpu.utils.timing import RecordTimings as JRecordTimings
from aat_tpu.utils.tracking import JsonlTracker as JTracker
from aat_tpu_torch.data import dataloaders as tdl
from aat_tpu_torch.data.datasets import SegmentedEmbeddingsDataset
from aat_tpu_torch.utils.timing import RecordTimings
from aat_tpu_torch.utils.tracking import JsonlTracker


def collate_ids(items, is_validation=False):
    return {"ids": np.asarray([it["i"] for it in items]), "val": is_validation}


def items(n, seed=0):
    lens = np.random.default_rng(seed).integers(100, 10_000, n)
    return [{"i": i, "audio": {"array": np.zeros(int(k))}} for i, k in enumerate(lens)]


ITERATORS = {
    "shuffle-drop-last": dict(n=10, batch_size=3, shuffle=True, drop_last=True, seed=0),
    "ordered-keep-last": dict(n=10, batch_size=3, shuffle=False, drop_last=False),
    "shards": dict(n=103, batch_size=5, shuffle=True, seed=7, shard_index=2, num_shards=4),
    "bucketed": dict(n=64, batch_size=8, shuffle=True, seed=1, bucket=True,
                     bucket_pool_batches=4),
    "bucketed-shards": dict(n=48, batch_size=4, shuffle=True, seed=3, bucket=True,
                            bucket_pool_batches=3, shard_index=1, num_shards=2),
    "validation": dict(n=7, batch_size=2, shuffle=False, drop_last=False, is_validation=True),
}


def make(mod, kw, prefetch):
    kw = dict(kw)
    data = items(kw.pop("n"))
    if kw.pop("bucket", False):
        kw["bucket_key"] = lambda it: len(it["audio"]["array"])
    return mod.BatchIterator(data, collate_ids, prefetch=prefetch, **kw)


@pytest.mark.parametrize("case", sorted(ITERATORS))
def test_batch_iterator_order_equals_jax(case):
    """Three epochs by auto-increment, then epochs 5 and 1 pinned with
    ``set_epoch``: the port's batches equal JAX's, with and without the
    prefetch thread."""
    kw = ITERATORS[case]
    want_it = make(jdl, kw, prefetch=0)
    got_its = [make(tdl, kw, prefetch=0), make(tdl, kw, prefetch=2)]
    for epoch in (None, None, None, 5, 1):
        if epoch is not None:
            for it in [want_it] + got_its:
                it.set_epoch(epoch)
        want = list(want_it)
        for it in got_its:
            got = list(it)
            assert len(got) == len(want) == len(it) == len(want_it)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["ids"], w["ids"])
                assert g["val"] == w["val"]


def test_build_dataloaders_equals_jax():
    args = (list(range(100)), list(range(50)))
    kw = dict(batch_size=10, few_train_samples=30, few_val_samples=5, seed=3)
    t_train, t_val = tdl.build_dataloaders(
        *[[{"i": i} for i in a] for a in args], collate_ids, **kw)
    j_train, j_val = jdl.build_dataloaders(
        *[[{"i": i} for i in a] for a in args], collate_ids, shard_index=0, num_shards=1, **kw)
    for t, j in ((t_train, j_train), (t_val, j_val)):
        assert len(t) == len(j)
        for g, w in zip(t, j):
            np.testing.assert_array_equal(g["ids"], w["ids"])
            assert g["val"] == w["val"]
    assert len(t_train) == 3 and all(b["val"] for b in t_val)


def test_prefetch_propagates_errors():
    """A collate error in the prefetch worker surfaces in the consumer, after
    the batches before it."""
    def bad_collate(batch):
        if any(it["i"] == 4 for it in batch):
            raise ValueError("poisoned item")
        return collate_ids(batch)

    it = tdl.BatchIterator(items(8), bad_collate, batch_size=2, shuffle=False,
                           drop_last=False, prefetch=2)
    seen = []
    with pytest.raises(ValueError, match="poisoned item"):
        for b in it:
            seen.append(b["ids"].tolist())
    assert seen == [[0, 1], [2, 3]]


def test_load_hf_dataset_needs_datasets(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="`datasets` package"):
        tdl.load_hf_dataset(str(tmp_path) + "/")


def test_load_hf_dataset_from_disk_equals_jax(tmp_path):
    import datasets

    ds = datasets.Dataset.from_dict({"id": ["a", "b"], "words": [["x"], ["y", "z"]]})
    ds.save_to_disk(str(tmp_path / "d.dataset"))
    got = tdl.load_hf_dataset(str(tmp_path / "d.dataset"))
    want = jdl.load_hf_dataset(str(tmp_path / "d.dataset"))
    assert list(got) == list(want) and len(got) == 2


def test_segmented_embeddings_dataset(tmp_path):
    emb = np.random.default_rng(0).normal(0, 1, (3, 8)).astype(np.float32)
    path = tmp_path / "item0.npy"
    np.save(path, emb)
    rows = [{"id": "a", "segments_embeddings_path": str(path)}]
    got, want = SegmentedEmbeddingsDataset(rows)[0], JDataset(rows)[0]
    assert len(SegmentedEmbeddingsDataset(rows)) == 1
    assert set(got) == set(want) and got["id"] == "a"
    np.testing.assert_array_equal(got["segments_embeddings"], want["segments_embeddings"])
    assert "segments_embeddings" not in rows[0]  # the source row is not modified


def test_jsonl_tracker_lines_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_MODE", "disabled")
    logs = [{"train/loss": 1.5}, {"train/loss": np.float32(1.0), "wer": 0.4}]
    files = []
    for cls, name in ((JsonlTracker, "port"), (JTracker, "jax")):
        tracker = cls(str(tmp_path / name / "m.jsonl"), config={"lr": 0.1})
        for m in logs:
            tracker.log(m)
        tracker.finish()
        files.append([json.loads(line) for line in open(tmp_path / name / "m.jsonl")])
    for lines in files:
        for line in lines:
            line.pop("_time", None)
    assert files[0] == files[1]
    assert files[0][0]["_config"]["lr"] == 0.1 and files[0][2] == {"_step": 2, "train/loss": 1.0,
                                                                   "wer": 0.4}


def test_jsonl_tracker_forwards_to_wandb(tmp_path, monkeypatch):
    """With ``wandb`` importable and ``WANDB_MODE`` not disabling it, every
    log is forwarded; ``WANDB_MODE=disabled`` keeps it out."""
    calls = []

    class FakeWandb:
        init = staticmethod(lambda **kw: calls.append(("init", kw["project"])))
        log = staticmethod(lambda m: calls.append(("log", dict(m))))
        finish = staticmethod(lambda: calls.append(("finish",)))

    monkeypatch.setitem(sys.modules, "wandb", FakeWandb)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    tracker = JsonlTracker(str(tmp_path / "a.jsonl"), project="p")
    tracker.log({"x": 1.0})
    tracker.finish()
    assert calls == [("init", "p"), ("log", {"x": 1.0}), ("finish",)]
    monkeypatch.setenv("WANDB_MODE", "disabled")
    tracker = JsonlTracker(str(tmp_path / "b.jsonl"))
    tracker.log({"x": 2.0})
    tracker.finish()
    assert len(calls) == 3


@pytest.mark.parametrize("cls", [RecordTimings, JRecordTimings])
def test_record_timings_accumulates(cls):
    timings = {}
    for _ in range(2):
        with cls(timings, "sleep"):
            time.sleep(0.01)
    with pytest.raises(KeyError):
        with cls(timings, "raised"):
            raise KeyError("x")  # the section is timed and the error passes through
    assert timings["sleep"] >= 0.02 and "raised" in timings
