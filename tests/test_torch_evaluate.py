"""The port's evaluation (``AATTrainer.evaluate``, ``generate_for_batch``,
``EarlyStopping`` and the eval step inside ``train``) against the JAX
trainer's on the same seeded tiny model and batches: whole-utterance,
segmented and raw-waveform batches (as ``tests/test_end_to_end.py``), the
port's attention gate forced down so its eval loss and generation prefix
take the flash route (on the CPU the kernels' plain versions), JAX on its
XLA attention (``tests/_torch_trajectories.py``). ``eval/loss`` within
1e-6 relative, the generated ids equal, every metric equal."""

import numpy as np
import pytest

from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu.training.metrics import ComputeMetrics as JMetrics
from aat_tpu.training.trainer import AATTrainer as JTrainer
from aat_tpu.training.trainer import EarlyStopping as JEarlyStopping
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.metrics import ComputeMetrics as TMetrics
from aat_tpu_torch.training.trainer import AATTrainer as TTrainer
from aat_tpu_torch.training.trainer import EarlyStopping, read_checkpoint_meta
from tests._torch_trajectories import (TRAIN, flash_route, jax_params, models, port_model,
                                       port_params, raw_batch, segmented_batch, whole_batch)
from tests._torch_threads import two_threads  # noqa: F401


class IdWords:
    """Decode-only tokenizer: id i → the word "w<i>", special ids 0-2
    (pad, bos, eos) skipped."""

    eos_token_id = 2

    def batch_decode(self, ids, skip_special_tokens=True):
        return [" ".join(f"w{int(i)}" for i in row if not (skip_special_tokens and 0 <= i <= 2))
                for row in np.asarray(ids)]


def with_prefix(batch):
    """Eval batches carry a text prefix: the caption's first two ids."""
    ids = np.asarray(batch["input_ids"])
    return {**batch, "prefix_input_ids": ids[:, :2],
            "prefix_attention_mask": np.ones((ids.shape[0], 2), np.int32)}


RAW = dict(segmentation="uniform", max_segment_frames=400, max_on_device_segments=5)


def trainers(monkeypatch, **train_kw):
    flash_route(monkeypatch)
    jm, tm = models()
    jp = jax_params(jm)
    cfg = dict(TRAIN, gradient_accumulation_steps=1, **train_kw)
    tok = IdWords()
    jt = JTrainer(jm, jp, JConfig(**cfg), compute_metrics=JMetrics(tok), tokenizer=tok)
    tt = TTrainer(tm, port_params(jp), TConfig(**cfg), compute_metrics=TMetrics(tok),
                  tokenizer=tok)
    return jt, tt


@pytest.mark.parametrize("kind", ["whole", "segmented", "raw"])
def test_evaluate_matches_jax(monkeypatch, kind):
    make, kw = {"whole": (whole_batch, {}), "segmented": (segmented_batch, {}),
                "raw": (raw_batch, RAW)}[kind]
    jt, tt = trainers(monkeypatch, **kw)
    rng = np.random.default_rng(11)
    batches = [with_prefix(make(rng)) for _ in range(2)]
    for b in batches:
        got, want = tt.generate_for_batch(b), np.asarray(jt.generate_for_batch(b))
        assert got.shape == want.shape == (2, 16)  # 16 * ceil(6 / 16) new tokens
        np.testing.assert_array_equal(got, want)
    mj = jt.evaluate(batches, with_generation=True)
    mt = tt.evaluate(batches, with_generation=True)
    assert set(mt) == set(mj) and "wer" in mt and "evaluate_meteor" in mt
    assert abs(mt["eval/loss"] - mj["eval/loss"]) <= 1e-6 * abs(mj["eval/loss"])
    for k in set(mj) - {"eval/loss"}:
        assert mt[k] == mj[k], k
    # without compute_metrics and with_generation unset: the loss alone
    tt.compute_metrics = None
    assert set(tt.evaluate(batches)) == {"eval/loss"}


def test_early_stopping_matches_jax():
    for patience, threshold in ((1, 0.01), (2, 0.01), (3, 0.5)):
        ours, theirs = EarlyStopping(patience, threshold), JEarlyStopping(patience, threshold)
        for loss in (3.0, 2.5, 2.499, 2.4, 2.6, 1.0, 1.0, 0.995, 0.99, 0.98):
            m = {"eval/loss": loss}
            assert ours.should_stop(m) == theirs.should_stop(m)
        assert (ours.best, ours.strikes) == (theirs.best, theirs.strikes)
    assert not EarlyStopping(1).should_stop({"wer": 1.0})  # metric absent


def test_train_evaluates_saves_and_stops_early(tmp_path):
    """``train`` evaluates every ``eval_steps`` and logs the eval dict,
    writes each checkpoint with the metric of an eval at that same step
    (and none for a save without one), tracks the best, and stops at the
    eval that early stopping rejects."""
    tm, params = port_model()
    logged = []
    cfg = TConfig(**dict(TRAIN, gradient_accumulation_steps=1, eval_steps=2, save_steps=1,
                         max_steps=10, output_dir=str(tmp_path), save_total_limit=0,
                         early_stopping_patience=1, early_stopping_threshold=1e9))
    t = TTrainer(tm, params, cfg,
                 compute_metrics=TMetrics(IdWords()), log_fn=logged.append, tokenizer=IdWords())
    rng = np.random.default_rng(5)
    data = [with_prefix(whole_batch(rng)) for _ in range(6)]
    t.train(data, eval_batches=lambda: data[:1])
    evals = [m for m in logged if "eval/loss" in m]
    assert t.state.step == 4 and len(evals) == 2  # the second eval stops it
    assert all(np.isfinite(m["eval/loss"]) and "wer" in m and "evaluate_bleu" in m
               for m in evals)
    metas = [read_checkpoint_meta(str(tmp_path / f"checkpoint-{s}")) for s in range(1, 4)]
    assert "eval/loss" not in metas[0] and "eval/loss" not in metas[2]
    assert metas[1]["eval/loss"] == evals[0]["eval/loss"]
    assert t._best_checkpoint == str(tmp_path / "checkpoint-2")
