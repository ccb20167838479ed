"""The pipeline's state under the port's trainer (gloo ranks,
``tests/_torch_parallel_workers.py``), mirroring JAX's pp tests:

- stage-resident masters and moments: each rank of a dp2 × pp2 trainer
  holds L/pp layers of both stacks, in its params and in its AdamW
  moments or Adafactor statistics, and the gathered state holds all L;
- a model reused by a one-process trainer after a pp trainer has its mesh
  and microbatch count cleared and runs the plain route;
- a pp checkpoint keeps the stacked layout on disk: resumed under the same
  mesh, 2 + 2 steps equal 4 uninterrupted ones bit for bit (params,
  moments, step; dropout 0.1); restored in one process, its params equal
  the saved ones bit for bit, the moments re-initialised with a warning;
  and a one-process checkpoint restores under pp bit for bit, whose
  ``save_pretrained`` exports the per-layer layout;
- ``evaluate`` with generation under dp2 × pp2 gives one process's
  ``eval/loss``, ids and metrics."""

import logging

import numpy as np
import pytest
import torch

from aat_tpu_torch.parallel import pipeline
from aat_tpu_torch.parallel.distributed import launch
from aat_tpu_torch.training import checkpoint as ckpt_lib

import _torch_parallel_workers as workers
from tests._torch_threads import two_threads  # noqa: F401

DP2_PP2 = {"dp": 2, "pp": 2}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_masters_and_moments_are_stage_resident(optimizer):
    out = launch(workers.residency_rank, 4, (DP2_PP2, optimizer), timeout=workers.TIMEOUT)
    for local, full in out:
        for stack in ("audio_encoder", "lm_decoder"):
            assert local[stack] == ([2], [2]), (stack, local[stack])  # 4 layers, 2 a stage
            assert full[stack] == [4]


def test_model_reuse_after_a_pp_trainer_runs_the_plain_route():
    out = launch(workers.reuse_rank, 2, ({"pp": 2},), timeout=workers.TIMEOUT)
    for routed, cleared, loss, collectives, refused in out:
        assert routed and cleared
        assert np.isfinite(loss) and collectives == 0
        assert refused is not None and "4 ranks" in refused


def _one_process(tmp_path, name, seed=0):
    model, params = workers.tiny_model(dropout=0.1, seed=seed)
    return workers.AATTrainer(model, params, workers.tiny_config(
        output_dir=str(tmp_path / name)))


def test_pp_checkpoints_resume_and_restore_across_layouts(tmp_path, caplog):
    out = launch(workers.checkpoint_rank, 4, (DP2_PP2, str(tmp_path)), timeout=workers.TIMEOUT)
    path, saved, uninterrupted, resumed = out[0]
    for other in out[1:]:
        assert other[0] == path
    for k in uninterrupted:
        np.testing.assert_array_equal(resumed[k], uninterrupted[k], err_msg=k)
    # on disk: the stacked layout, its moments likewise
    on_disk = ckpt_lib.read_params(path, "cpu")["params"]
    assert tuple(on_disk["audio_encoder.layers.attention.q.kernel"].shape) == (2, 32, 32)
    assert "opt.mu.lm_decoder.layers.mlp.up.kernel" in saved
    # one process restores the params bit for bit; the moments restart
    single = _one_process(tmp_path, "single", seed=3)
    with caplog.at_level(logging.WARNING):
        single.restore_checkpoint(path)
    assert "optimizer state not restorable" in caplog.text
    assert single.state.step == 2 and int(single.state.opt_state.count) == 0
    got = workers.flat_numpy(single.state.params)
    want = pipeline.flat_to_layout({k: torch.as_tensor(v) for k, v in saved.items()
                                    if not k.startswith("opt.")}, single.state.params)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)

    # and the reverse: a one-process checkpoint restored under pp
    trainer = _one_process(tmp_path, "one")
    trainer.training_step([workers.equiv_batch(ragged=True)])
    one_path = trainer.save_checkpoint()
    want = workers.flat_numpy(trainer.state.params)
    out = launch(workers.restore_rank, 4, (DP2_PP2, one_path, str(tmp_path / "export")),
                 timeout=workers.TIMEOUT)
    for step, params, opt, _ in out:
        assert step == 1 and int(opt["count"]) == 0
        full = pipeline.flat_to_layout({k: torch.as_tensor(v) for k, v in params.items()},
                                       trainer.state.params)
        assert set(full) == set(want)
        for k in want:
            np.testing.assert_array_equal(full[k].numpy(), want[k], err_msg=k)
    export_keys = out[0][3]
    assert "audio_encoder.layers.0.attention.q.kernel" in export_keys
    assert not any(k.startswith("audio_encoder.layers.attention") for k in export_keys)


def test_evaluate_under_pp_equals_one_process():
    batches = [workers.equiv_batch(ragged=True), workers.whole_utterance_batch(ragged=True)]
    want, want_ids = workers.evaluate_run(workers.eval_trainer(), batches)
    out = launch(workers.evaluate_rank, 4, (DP2_PP2, True), timeout=workers.TIMEOUT)
    for metrics, ids in out:
        assert set(metrics) == set(want)
        assert abs(metrics["eval/loss"] - want["eval/loss"]) < 1e-5
        for got, ref in zip(ids, want_ids):
            np.testing.assert_array_equal(got, ref)
        for key in set(want) - {"eval/loss"}:
            assert metrics[key] == pytest.approx(want[key], abs=1e-12), key
