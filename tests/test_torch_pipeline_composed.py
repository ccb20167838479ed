"""Pipeline-parallel training composed with the other axes, LayerDrop, and
the pipeline's planted faults, at JAX's ``tests/test_multichip.py`` bars
after 2 steps (loss |Δ| < 1e-5, parameter max |Δ| < 1e-4, every rank)
against the port's one-process trainer and JAX's one-device trainer
(``tests/_torch_parallel_cases.py``):

- dp2 × tp2 × pp2 (8 ranks): the stacks are tp-sharded too (q
  ``("pp", None, "tp")``, its bias ``("pp", "tp")``, the LM's down
  ``("pp", "tp", None)``, as JAX asserts; ``test_torch_pipeline.py``
  holds the specs) and the stage bodies are Megatron bodies; with dropout
  0.2 too, the bodies' head and column shards keying their masks on their
  global places;
- dp2 × fsdp2 × pp2 (8 ranks): the stacked matrices fsdp-sharded,
  gathered once a step, their gradients reduce-scattered back;
- LayerDrop 0.5 on 4-layer stacks (two layers a stage): decided once a
  layer a step on the *global* layer index, which a stage-local index
  would not reproduce here;
- the two planted boundary faults (the result leaving through an
  all-reduce whose gradient is summed too; the input entering without the
  sum of the stages' gradients) break the bars by 10 times or more. AdamW
  is blind to a gradient scaled as a whole, so these run with the LM's
  head tied to its embeddings, whose gradient mixes the head's share with
  the pipeline's."""

import dataclasses

import pytest

from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models.hubert import _dropped
from aat_tpu_torch.ops.dropout import fold_seed

import _torch_parallel_workers as workers
from _torch_parallel_cases import LOSS_BAR, PARAM_BAR, case, check_case, mesh_diffs


@pytest.mark.parametrize("name", ["dp2_tp2_pp2", "dp2_fsdp2_pp2", "dp2_pp2_tied",
                                  "dp2_tp2_pp2_dropout"])
def test_composed_pipeline_step_equals_one_process(name):
    check_case(name)


def test_layerdrop_keys_on_the_global_layer_index():
    """The case drops some layers and keeps others over its 2 steps, and a
    stage keyed on its local index would decide otherwise."""
    model, params = workers.tiny_model(layers=4, layerdrop=0.5)
    trainer = workers.AATTrainer(model, params, workers.tiny_config())
    cfg = dataclasses.replace(thub.tiny_test_config(), layerdrop=0.5)

    def decisions(index):
        out = []
        for step in range(2):
            # the encoder's seed: the step's, then the encoder site's (the
            # trainer's and hubert_encode's folds)
            enc = fold_seed(fold_seed(trainer.dropout_seed(step, 0), 0), 1)
            out.append([_dropped(cfg, fold_seed(enc, index(i))) for i in range(4)])
        return out

    dropped = decisions(lambda i: i)
    assert any(map(any, dropped)) and not all(map(all, dropped))
    assert decisions(lambda i: i % 2) != dropped
    check_case("dp2_pp2_layerdrop")


@pytest.mark.parametrize("fault", ["pipeline_exit_sum", "pipeline_entry_identity"])
def test_planted_pipeline_faults_break_the_bars(fault):
    mesh, world, batch, dropout, config_kw, model_kw = case("dp2_pp2_tied")
    (loss_diff, param_diff), _ = mesh_diffs(mesh, world, batch, dropout, config_kw, fault=fault,
                                            model_kw=model_kw)
    assert loss_diff > 10 * LOSS_BAR or param_diff > 10 * PARAM_BAR, (fault, loss_diff,
                                                                     param_diff)
