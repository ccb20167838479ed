"""The multi-device training cases of ``tests/test_torch_parallel_training*.py``
and their two references: the port's one-process trainer and JAX's
one-device trainer (``tests/test_multichip.py::_tiny_trainer``: the same
tiny model and settings), both on the global batch from the same initial
parameters. This module imports JAX; the ranks
(``tests/_torch_parallel_workers.py``) do not."""

import dataclasses
import functools

import jax
import numpy as np

from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.models.aslm import AslmConfig, AslmModel
from aat_tpu.training.config import TrainingConfig
from aat_tpu.training.trainer import AATTrainer
from aat_tpu_torch.parallel.distributed import launch
from aat_tpu_torch.utils.port import from_jax_params, to_jax_params

import _torch_parallel_workers as workers

LOSS_BAR, PARAM_BAR = 1e-5, 1e-4  # JAX's tests/test_multichip.py:135-136

# name: (mesh, ranks, batch, dropout[, config overrides[, model overrides]]);
# the model overrides are ``workers.tiny_model``'s (layers, layerdrop, tied)
CASES = {
    "dp4_dropout": ({"dp": 4}, 4, "segmented", 0.2),
    "dp2_fsdp2_dropout_whole": ({"dp": 2, "fsdp": 2}, 4, "whole", 0.2),
    "dp2_fsdp2_tp2": ({"dp": 2, "fsdp": 2, "tp": 2}, 8, "segmented", 0.0),
    "dp2_sp2_whole": ({"dp": 2, "sp": 2}, 4, "whole", 0.0),
    # the clip binds: the tiny model's first gradient norm is about 2
    "dp2_fsdp2_clip": ({"dp": 2, "fsdp": 2}, 4, "segmented", 0.0, {"grad_clip_norm": 0.5}),
    # Adafactor under dp alone: replicated leaves, the optimizer as it is
    "dp2_adafactor": ({"dp": 2}, 2, "segmented", 0.0,
                      {"optimizer": "adafactor", "learning_rate": None}),
    # Adafactor's statistics over fsdp-sharded leaves
    "dp2_fsdp2_adafactor": ({"dp": 2, "fsdp": 2}, 4, "segmented", 0.0,
                            {"optimizer": "adafactor", "learning_rate": None}),
    # the pipeline: one layer a stage (2 layers), or two (4 layers)
    "dp2_pp2": ({"dp": 2, "pp": 2}, 4, "segmented", 0.0),
    "dp2_pp2_whole": ({"dp": 2, "pp": 2}, 4, "whole", 0.0),
    "dp2_pp2_dropout": ({"dp": 2, "pp": 2}, 4, "whole", 0.2),
    "dp2_pp2_clip": ({"dp": 2, "pp": 2}, 4, "segmented", 0.0, {"grad_clip_norm": 0.5}),
    "dp2_pp2_layerdrop": ({"dp": 2, "pp": 2}, 4, "segmented", 0.0, {},
                          {"layers": 4, "layerdrop": 0.5}),
    "dp2_tp2_pp2": ({"dp": 2, "tp": 2, "pp": 2}, 8, "segmented", 0.0),
    "dp2_fsdp2_pp2": ({"dp": 2, "fsdp": 2, "pp": 2}, 8, "segmented", 0.0),
    # a tied head: its gradient mixes the pipeline's (input embeddings) and
    # the head's, so the pipeline's planted faults move AdamW's update
    "dp2_pp2_tied": ({"dp": 2, "pp": 2}, 4, "segmented", 0.0, {}, {"tied": True}),
    # JAX's pp math: Adafactor factors the stacked leaves, so the reference
    # is the one-process trainer on the stacked tree
    "dp2_pp2_adafactor": ({"dp": 2, "pp": 2}, 4, "segmented", 0.0,
                          {"optimizer": "adafactor", "learning_rate": None}),
}
STACKED_REFERENCE = {"dp2_pp2_adafactor"}


def case(name):
    """(mesh, ranks, batch, dropout, config overrides, model overrides)."""
    mesh, world, batch, dropout, *rest = CASES[name]
    return (mesh, world, batch, dropout, rest[0] if rest else None,
            rest[1] if len(rest) > 1 else None)


def mesh_diffs(mesh, world, batch, dropout, config_kw=None, fault=None, model_kw=None,
               stacked=False):
    """(loss |Δ|, param max |Δ|) of every rank after 2 steps against the
    port's one-process trainer (on the stacked tree with ``stacked``), and
    the ranks' runs."""
    ref = workers.reference_run(batch, dropout, ragged=True, config_kw=config_kw,
                                model_kw=model_kw, stacked=stacked)
    ranks = launch(workers.train_rank, world,
                   (mesh, batch, dropout, True, 2, fault, config_kw, model_kw),
                   timeout=workers.TIMEOUT)
    return workers.worst_diffs(ref, ranks), ranks


@functools.lru_cache(maxsize=None)
def _jax_run(batch_name, config_items, model_items):
    model_kw = dict(model_items)
    model, params = workers.tiny_model(**model_kw)
    tcfg = workers.tiny_config(**dict(config_items))
    layers = dict(num_hidden_layers=model_kw.get("layers", 2))
    jm = AslmModel(AslmConfig(projection_type="linear", audio_encoder_hidden=32, lm_hidden=32,
                              projection_hidden=48),
                   dataclasses.replace(jhub.tiny_test_config(), **layers),
                   dataclasses.replace(jllm.tiny_test_config(), **layers,
                                       tie_word_embeddings=model_kw.get("tied", False)))
    jcfg = TrainingConfig(**{name: getattr(tcfg, name)
                             for name in TrainingConfig.__dataclass_fields__})
    trainer = AATTrainer(jm, to_jax_params(params), jcfg)
    batch = workers.BATCHES[batch_name](ragged=True)
    losses = [float(trainer.training_step([batch])["train/loss"]) for _ in range(2)]
    return losses, workers.flat_numpy(
        from_jax_params(jax.tree.map(np.array, jax.device_get(trainer.state.params))))


def jax_run(batch_name, config_kw=None, model_kw=None):
    """JAX's one-device trainer, dropout and LayerDrop off, 2 steps on the
    global batch from the port's initial parameters → (losses, the params
    in the port's layout)."""
    model_kw = {k: v for k, v in (model_kw or {}).items() if k != "layerdrop"}
    return _jax_run(batch_name, tuple(sorted((config_kw or {}).items())),
                    tuple(sorted(model_kw.items())))


def check_case(name):
    """Every rank within JAX's bars of the one-process port. With dropout
    and LayerDrop off the ranks are also held to JAX's trainer; with either
    on (the two packages draw different masks and layers), the one-process
    port with both off is."""
    mesh, world, batch, dropout, config_kw, model_kw = case(name)
    stacked = name in STACKED_REFERENCE
    (loss_diff, param_diff), ranks = mesh_diffs(mesh, world, batch, dropout, config_kw,
                                                model_kw=model_kw, stacked=stacked)
    assert loss_diff < LOSS_BAR, loss_diff
    assert param_diff < PARAM_BAR, param_diff
    if stacked:  # JAX's pp math differs from its one-device Adafactor
        return
    if dropout or (model_kw or {}).get("layerdrop"):
        quiet = {**(model_kw or {}), "layerdrop": 0.0}
        ranks = [workers.reference_run(batch, 0.0, ragged=True, config_kw=config_kw,
                                       model_kw=quiet)]
    loss_diff, param_diff = workers.worst_diffs(jax_run(batch, config_kw, model_kw), ranks)
    assert loss_diff < LOSS_BAR, ("against JAX", loss_diff)
    assert param_diff < PARAM_BAR, ("against JAX", param_diff)
