"""Evaluation, checkpoints, batch norm and model reuse under the port's
meshes, against one process (gloo ranks, ``tests/_torch_parallel_workers.py``):

- ``evaluate`` under dp2 gives one process's ``eval/loss`` (the global
  batch's, captions padded differently across the ranks), generated ids
  and metrics;
- a dp2 × fsdp2 checkpoint (gathered, written by rank 0) restores in one
  process to the gathered state bit for bit, params and moments; and 2
  steps, a save, a restore into a fresh mesh trainer and 2 more steps
  equal 4 uninterrupted steps bit for bit (dropout 0.1);
- EfficientNet-b0's train-mode batch norm under dp2 normalizes with the
  global batch's statistics: features, input gradients and the running
  statistics' batch terms equal one process's within 4 times its own
  spread under another row order, where each rank's local statistics
  miss by more than 100 times it;
- a model reused by a one-process trainer after a mesh trainer has its
  mesh cleared and runs the plain route (no collective); a mesh larger
  than the world raises."""

import numpy as np
import pytest
import torch

from aat_tpu_torch.models import efficientnet as eff
from aat_tpu_torch.parallel.distributed import launch
from aat_tpu_torch.training import checkpoint as ckpt_lib

import _torch_parallel_workers as workers
from tests._torch_threads import two_threads  # noqa: F401


def test_evaluate_under_dp_equals_one_process():
    batches = [workers.equiv_batch(ragged=True), workers.whole_utterance_batch(ragged=True)]
    want, want_ids = workers.evaluate_run(workers.eval_trainer(), batches)
    out = launch(workers.evaluate_rank, 2, ({"dp": 2}, True), timeout=workers.TIMEOUT)
    for metrics, ids in out:
        assert set(metrics) == set(want)
        assert abs(metrics["eval/loss"] - want["eval/loss"]) < 1e-5
        for got, ref in zip(ids, want_ids):
            np.testing.assert_array_equal(got, ref)
        for key in set(want) - {"eval/loss"}:
            assert metrics[key] == pytest.approx(want[key], abs=1e-12), key


def test_mesh_checkpoint_restores_anywhere(tmp_path):
    out = launch(workers.checkpoint_rank, 4, ({"dp": 2, "fsdp": 2}, str(tmp_path)),
                 timeout=workers.TIMEOUT)
    path, saved, uninterrupted, resumed = out[0]
    for other in out[1:]:
        assert other[0] == path
        for k in saved:
            np.testing.assert_array_equal(other[1][k], saved[k])
    for k in uninterrupted:
        np.testing.assert_array_equal(resumed[k], uninterrupted[k], err_msg=k)
    # one process restores the gathered state bit for bit
    model, params = workers.tiny_model(dropout=0.1)
    single = workers.AATTrainer(model, params, workers.tiny_config())
    single.restore_checkpoint(path)
    assert single.state.step == 2
    got = {**workers.flat_numpy(single.state.params),
           **{f"opt.{k}": v for k, v in workers.flat_numpy(single.state.opt_state).items()}}
    assert set(got) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    # and its params are the full ones (fsdp shards gathered)
    q = single.state.params["audio_encoder"]["layers"][0]["attention"]["q"]["kernel"]
    assert tuple(q.shape) == (32, 32)


def _bn_run(params, images):
    x = torch.as_tensor(images).requires_grad_(True)
    feats, stats = eff.EfficientNetAudioEncoderAdapter()(params, x, train=True)
    (feats.square().sum() * 1e-3).backward()
    return (feats.detach().numpy(), x.grad.numpy(),
            {k: v.numpy() for k, v in ckpt_lib.flatten(stats).items()})


def _worst(a, b) -> float:
    return max(float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max()),
               max(float(np.abs(a[2][k] - b[2][k]).max()) for k in a[2]))


def test_global_batch_norm_under_dp():
    """b0's 49 batch norms over 4 images amplify the rounding of the
    statistics' sums, so the bound is set by one process's own spread
    under another row order (sums in another order) and a rank's local
    statistics must miss by far more."""
    torch.set_num_threads(workers.RANK_THREADS)  # the ranks' reduction order within a rank
    images = np.random.default_rng(5).normal(0, 1, (4, 1, 64, 48)).astype(np.float32)
    params = eff.init_efficientnet_params(0, device="cpu")
    want = _bn_run(params, images)
    order = [2, 3, 0, 1]
    permuted = _bn_run(params, images[order])
    back = np.argsort(order)
    spread = _worst(want, (permuted[0][back], permuted[1][back], permuted[2]))
    assert 0 < spread < 1e-3
    halves = [_bn_run(params, images[:2]), _bn_run(params, images[2:])]
    local = (np.concatenate([h[0] for h in halves]), np.concatenate([h[1] for h in halves]),
             halves[0][2])
    assert _worst(want, local) > 100 * spread

    out = launch(workers.bn_rank, 2, (images,), timeout=workers.TIMEOUT)
    got = (np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out]))
    for rank_stats in (o[2] for o in out):
        assert set(rank_stats) == set(want[2])
        worst = _worst(want, (*got, rank_stats))
        assert worst <= 4 * spread, (worst, spread)


def test_model_reuse_after_a_mesh_trainer_runs_the_plain_route():
    out = launch(workers.reuse_rank, 2, timeout=workers.TIMEOUT)
    for routed, cleared, loss, collectives, refused in out:
        assert routed and cleared
        assert np.isfinite(loss) and collectives == 0
        assert refused is not None and "4 ranks" in refused
