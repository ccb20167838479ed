"""The port's pipeline against JAX's own pipeline trainer on its 8 virtual
CPU devices (``aat_tpu/parallel/pipeline.py`` under ``shard_map``):

- a JAX dp2 × pp2 run's orbax checkpoint (stacked params and AdamW
  moments) converted by ``utils/port.checkpoint_from_jax`` keeps the
  stacked layout: a port dp2 × pp2 trainer restores its params, moments
  and step bit for bit, and a one-process port trainer its params (the
  moments re-initialised across the layouts);
- slow (JAX compiles its ``shard_map`` scan, and marks its own pp tests
  slow): the port's dp2 × pp2 AdamW and Adafactor trainers within JAX's
  bars of JAX's dp2 × pp2 trainer after 2 steps from the same initial
  parameters. Under pp JAX's Adafactor factors the stacked leaves, a
  different update from its one-device one; the port follows it."""

import logging
import os

import jax
import numpy as np
import pytest

from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.models.aslm import AslmConfig, AslmModel
from aat_tpu.parallel import mesh as jmesh
from aat_tpu.parallel.pipeline import unstack_model_layers
from aat_tpu.training.config import TrainingConfig
from aat_tpu.training.trainer import AATTrainer
from aat_tpu_torch.parallel.distributed import launch
from aat_tpu_torch.utils.port import checkpoint_from_jax, from_jax_params, to_jax_params

import _torch_parallel_workers as workers
from _torch_parallel_cases import LOSS_BAR, PARAM_BAR

DP2_PP2 = {"dp": 2, "pp": 2}


def jax_pp_trainer(output_dir, **config_kw):
    """JAX's dp2 × pp2 trainer on the tiny model, from the port's initial
    parameters (``workers.tiny_model``), with the tiny settings."""
    _, params = workers.tiny_model()
    tcfg = workers.tiny_config(DP2_PP2, output_dir=output_dir, **config_kw)
    jm = AslmModel(AslmConfig(projection_type="linear", audio_encoder_hidden=32, lm_hidden=32,
                              projection_hidden=48),
                   jhub.tiny_test_config(), jllm.tiny_test_config())
    jcfg = TrainingConfig(**{name: getattr(tcfg, name)
                             for name in TrainingConfig.__dataclass_fields__})
    return AATTrainer(jm, to_jax_params(params), jcfg, mesh=jmesh.make_mesh(2, 1, 1, 1, 2))


def _port_layout(tree):
    """A JAX (stacked or per-layer) params-shaped tree → flat numpy in the
    port's layout, stacked where it is stacked."""
    return workers.flat_numpy(from_jax_params(jax.tree.map(np.asarray, jax.device_get(tree))))


def test_jax_pp_checkpoint_converts_and_restores(tmp_path, caplog):
    import orbax.checkpoint as ocp

    jt = jax_pp_trainer(str(tmp_path / "jax"))
    jt.training_step([workers.equiv_batch(ragged=True)])
    jpath = jt.save_checkpoint()
    template = {"params": jt.state.params, "opt_state": jt.state.opt_state, "step": jt.state.step}
    state = jax.device_get(ocp.StandardCheckpointer().restore(os.path.join(jpath, "state"),
                                                              target=template))
    path = checkpoint_from_jax(state, str(tmp_path / "port" / "checkpoint-1"))
    want = _port_layout(state["params"])
    assert tuple(want["audio_encoder.layers.attention.q.kernel"].shape) == (2, 32, 32)
    want_opt = {f"{name}.{k}": v for name in ("mu", "nu")
                for k, v in _port_layout(getattr(state["opt_state"], name)).items()}

    out = launch(workers.restore_rank, 4, (DP2_PP2, path), timeout=workers.TIMEOUT)
    for step, params, opt, _ in out:
        assert step == 1 and int(opt["count"]) == 1
        assert set(params) == set(want)
        for k in want:
            np.testing.assert_array_equal(params[k], want[k], err_msg=k)
        for k in want_opt:
            np.testing.assert_array_equal(opt[k], want_opt[k], err_msg=k)

    model, params = workers.tiny_model(seed=3)
    single = workers.AATTrainer(model, params, workers.tiny_config())
    with caplog.at_level(logging.WARNING):
        single.restore_checkpoint(path)
    assert "optimizer state not restorable" in caplog.text
    flat = {k: unstack_model_layers(v) if isinstance(v, dict) else v
            for k, v in state["params"].items()}
    got, per_layer = workers.flat_numpy(single.state.params), _port_layout(flat)
    assert set(got) == set(per_layer)
    for k in got:
        np.testing.assert_array_equal(got[k], per_layer[k], err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("config_kw", [{}, {"optimizer": "adafactor", "learning_rate": None}],
                         ids=["adamw", "adafactor"])
def test_pipeline_trainer_equals_jax_pipeline_trainer(tmp_path, config_kw):
    jt = jax_pp_trainer(str(tmp_path), **config_kw)
    batch = workers.equiv_batch(ragged=True)
    losses = [float(jt.training_step([batch])["train/loss"]) for _ in range(2)]
    params = {k: unstack_model_layers(v) if isinstance(v, dict) else v
              for k, v in jt.state.params.items()}
    ref = losses, _port_layout(params)
    ranks = launch(workers.train_rank, 4, (DP2_PP2, "segmented", 0.0, True, 2, None, config_kw),
                   timeout=workers.TIMEOUT)
    loss_diff, param_diff = workers.worst_diffs(ref, ranks)
    assert loss_diff < LOSS_BAR, loss_diff
    assert param_diff < PARAM_BAR, param_diff
