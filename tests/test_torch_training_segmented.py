"""Port ``AATTrainer`` vs the JAX package's on segmented batches (the
``AATTrainerSegmentation`` path: [B, S, F] segments flattened into the
encoder batch), 3 steps at gradient accumulation 1 and 2, f32, the port on
its flash route and JAX on its XLA attention
(``tests/_torch_trajectories.py``)."""

import pytest

from tests._torch_trajectories import assert_trajectories, flash_route, run_both, segmented_batch
from tests._torch_threads import two_threads  # noqa: F401


@pytest.mark.parametrize("accum", [1, 2])
def test_segmented_trajectory_matches_jax(monkeypatch, accum):
    flash_route(monkeypatch)
    r = run_both(segmented_batch, accum=accum, seed=accum, trainer="AATTrainerSegmentation")
    assert_trajectories(r.losses, *r.params[-1], 2e-4)
