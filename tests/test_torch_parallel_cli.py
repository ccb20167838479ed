"""The train command line under two gloo ranks started as ``torchrun``
starts them (``RANK`` / ``WORLD_SIZE`` / ``MASTER_*``; ``--mesh-dp 2``), at
tiny widths for one step with an evaluation and a save: each rank reads
its data rank's shard of the training and validation items, and only rank
0 writes checkpoints, ``data_state.json`` and ``metrics.jsonl`` (each rank
is given its own ``--output-dir``, so a write by rank 1 would show)."""

import json
import os

from aat_tpu_torch.parallel.distributed import launch

import _torch_parallel_workers as workers


def test_train_cli_under_two_ranks(tmp_path):
    dirs = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
    out = launch(workers.cli_rank, 2, (dirs,), timeout=workers.TIMEOUT)
    train_seen = [set(o[0]) for o in out]
    val_seen = [set(o[1]) for o in out]
    assert train_seen[0] and train_seen[1] and not train_seen[0] & train_seen[1]
    assert val_seen == [{"valid0", "valid2"}, {"valid1", "valid3"}]
    assert [o[2] for o in out] == [(0, 2), (1, 2)]
    assert all(o[3] == 1 for o in out)

    run0, run1 = (d + "_1_linear_none" for d in dirs)
    assert not os.path.exists(run1)
    assert {"checkpoint-1", "metrics.jsonl"} <= set(os.listdir(run0))
    files = set(os.listdir(os.path.join(run0, "checkpoint-1")))
    assert {"params.pt", "optimizer.pt", "trainer_meta.json", "data_state.json"} <= files
    with open(os.path.join(run0, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert any("train/loss" in line for line in lines)
    assert any("eval/loss" in line for line in lines)
