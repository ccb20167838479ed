"""Pipeline-parallel training steps of the port (``AATTrainer`` with
``mesh_pp``; ``aat_tpu_torch/parallel/pipeline.py``) at JAX's
``tests/test_multichip.py`` bars after 2 steps: loss |Δ| < 1e-5 and
parameter max |Δ| < 1e-4, on every rank, against the port's one-process
trainer and, with dropout off, against JAX's one-device trainer
(``tests/_torch_parallel_cases.py``), mirroring JAX's pp tests:

- dp2 × pp2 on segmented and on whole-utterance batches (one layer a
  stage of the tiny encoder and LM);
- dp2 × pp2 with dropout 0.2: each microbatch's masks are keyed as its
  first global row, so they equal one process's (and the one-process port
  at dropout 0 equals JAX's);
- dp2 × pp2 with a global-norm clip of 0.5 that binds, and the gradient
  norms themselves equal one process's (each stage's layers counted once,
  across the pp group); a batch non-finite on one data rank's rows drops
  the update on every rank.

The tp and fsdp compositions, LayerDrop and the planted faults are in
``test_torch_pipeline_composed.py``."""

import pytest

from aat_tpu_torch.parallel.distributed import launch

import _torch_parallel_workers as workers
from _torch_parallel_cases import check_case


@pytest.mark.parametrize("case", ["dp2_pp2", "dp2_pp2_whole", "dp2_pp2_dropout", "dp2_pp2_clip"])
def test_pipeline_step_equals_one_process(case):
    check_case(case)


def test_the_guard_and_the_norms_are_global_under_pp():
    """The gradient norms under dp2 × pp2 (each stage's stacked layers
    counted once, across the pp group) equal one process's, and a batch
    that is non-finite on one data rank's rows drops the update on every
    rank. (A binding clip alone barely moves AdamW's update, which is
    blind to a gradient scaled as a whole: the norms are held here.)"""
    model, params = workers.tiny_model()
    want = workers.grad_norms(workers.AATTrainer(model, params, workers.tiny_config()),
                              workers.equiv_batch(ragged=True))
    out = launch(workers.guard_rank, 4, ({"dp": 2, "pp": 2},), timeout=workers.TIMEOUT)
    for norms, skipped, unchanged in out:
        assert norms == pytest.approx(want, rel=1e-6)
        assert skipped == 1.0 and unchanged
