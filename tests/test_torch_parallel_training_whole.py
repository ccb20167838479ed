"""Multi-device training steps of the port on whole utterances, and
Adafactor, at JAX's ``tests/test_multichip.py`` bars after 2 steps (loss
|Δ| < 1e-5, parameter max |Δ| < 1e-4, on every rank) against the port's
one-process trainer and, with dropout off, JAX's one-device trainer
(``tests/_torch_parallel_cases.py``):

- dp2 × fsdp2 with dropout 0.2: the masks equal one device's (and the
  one-process port at dropout 0 equals JAX's);
- dp2 × sp2: Ulysses attention, the tiny encoder's T = 19 padded to 20;
- dp2 × tp2 with dropout 0.2: the head shards' attention masks and the
  column shards' activation masks keyed on their global places, so they
  equal one device's;
- dp2 with Adafactor (replicated state)."""

import pytest

from _torch_parallel_cases import check_case


@pytest.mark.parametrize("case", ["dp2_fsdp2_dropout_whole", "dp2_sp2_whole", "dp2_adafactor",
                                  "dp2_tp2_dropout"])
def test_mesh_step_equals_one_process(case):
    check_case(case)
