"""Multi-device training steps of the port (``aat_tpu_torch/parallel``,
``AATTrainer`` with ``mesh_*``) on segmented batches, at JAX's
``tests/test_multichip.py`` bars after 2 steps: loss |Δ| < 1e-5 and
parameter max |Δ| < 1e-4, on every rank, against the port's one-process
trainer and, with dropout off, against JAX's one-device trainer
(``tests/_torch_parallel_cases.py``; the whole-utterance and Adafactor
cases are in ``test_torch_parallel_training_whole.py``).

Gloo ranks on the CPU (``tests/_torch_parallel_workers.py``), on JAX's
tiny model (HuBERT with 4 heads, a 4/2-head LM: both tp-partitionable
at tp = 2) and batches, whose captions pad differently across the data
ranks, so a mean of per-rank means would miss:

- dp4 with dropout 0.2: the masks equal one device's (and the
  one-process port at dropout 0 equals JAX's);
- dp2 × fsdp2 × tp2 (8 ranks): sharded masters, the vocab-sharded
  embeddings gathered, Megatron bodies in the encoder and the LM;
- dp2 × fsdp2 with a global-norm clip that binds; the gradient norms
  (the sharded tree's, each replicated leaf counted once) equal one
  process's; a batch that is non-finite on one rank's rows only drops the
  update on every rank;
- two planted faults break the bars: a rank that keeps its own gradients
  instead of the reduced ones, and dp4 masks keyed as the batch's first
  rows on every rank."""

import pytest

from aat_tpu_torch.parallel.distributed import launch

import _torch_parallel_workers as workers
from _torch_parallel_cases import CASES, PARAM_BAR, check_case, mesh_diffs


@pytest.mark.parametrize("case", ["dp4_dropout", "dp2_fsdp2_tp2", "dp2_fsdp2_clip"])
def test_mesh_step_equals_one_process(case):
    check_case(case)


@pytest.mark.parametrize("fault, case", [("no_reduce", "dp2_fsdp2_dropout_whole"),
                                         ("unshifted_dropout", "dp4_dropout")])
def test_planted_faults_break_the_bars(fault, case):
    mesh, world, batch, dropout, *_ = CASES[case]
    (_, param_diff), _ = mesh_diffs(mesh, world, batch, dropout, fault=fault)
    assert param_diff > 10 * PARAM_BAR, (fault, param_diff)


def test_the_guard_and_the_norms_are_global():
    model, params = workers.tiny_model()
    want = workers.grad_norms(workers.AATTrainer(model, params, workers.tiny_config()),
                              workers.equiv_batch(ragged=True))
    out = launch(workers.guard_rank, 4, ({"dp": 2, "fsdp": 2},), timeout=workers.TIMEOUT)
    for norms, skipped, unchanged in out:
        assert norms == pytest.approx(want, rel=1e-6)
        assert skipped == 1.0 and unchanged
