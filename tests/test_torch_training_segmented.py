"""Port ``AATTrainer`` vs the JAX package's on segmented batches (the
``AATTrainerSegmentation`` path: [B, S, F] segments flattened into the
encoder batch), 3 steps at gradient accumulation 1 and 2, f32, flash route
forced on both (helpers in test_torch_training.py)."""

import pytest

from aat_tpu_torch.training.trainer import AATTrainerSegmentation
from test_torch_training import assert_trajectories, run_both, segmented_batch


@pytest.mark.parametrize("accum", [1, 2])
def test_segmented_trajectory_matches_jax(monkeypatch, accum):
    losses, jparams, tparams, _, _ = run_both(monkeypatch, segmented_batch, accum,
                                              trainer_cls=AATTrainerSegmentation)
    assert_trajectories(losses, jparams, tparams, 2e-4)
