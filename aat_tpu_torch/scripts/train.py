"""ASLM training command line (counterpart of ``scripts/train.py``).

    python -m aat_tpu_torch.scripts.train [--test-run] [--finetune] [--profile] \\
        [--dataset <hub-name-or-dir>] [--pretrained/--no-pretrained] \\
        [--resume-from-checkpoint <dir>] [--<any TrainingConfig field> <value>] ...

The preset is ``projection_training_config()``, or
``finetuning_lm_config()`` with ``-f``, or ``overfit_one_batch_config()``
with ``-p`` (which also profiles the run with cProfile into
``train_profile.prof``); every ``TrainingConfig`` field is a flag. With
``--pretrained`` (the default) ``--audio-encoder-checkpoint`` and
``--lm-pretrained-model`` name local HF checkpoint directories, and the
tokenizer is read from the latter (``transformers``); ``--dataset`` needs
the ``datasets`` package. Metrics go to ``<output_dir>/metrics.jsonl``.

A resumed run restores once, derives its epoch from the restored step,
pins each epoch's shuffle with ``set_epoch`` and fast-forwards only the
interrupted epoch. The collators draw noise, crops and prefixes from
seeded generators; each checkpoint records, in ``data_state.json``, the
training collator's generator state at the start of the epoch it belongs
to and the validation collator's, so the resumed run, whose fast-forward
collates the skipped batches again, draws what the uninterrupted run drew
(the JAX script records neither; its validation batches also share the
training collator, whose prefetch thread makes their order of draws
depend on timing, so here validation has a collator of its own). Neither
this port nor the JAX package restores the best-metric record, so with
``load_best_model_at_end`` a resumed run's ``finalize`` may pick another
checkpoint than an uninterrupted run's.
``unfreeze_lm_at_epoch`` unfreezes the LM at the start of that epoch
(``AATTrainer.unfreeze_lm_decoder``); a run resumed from a checkpoint whose
``trainer_meta.json`` says the LM trained unfreezes it before restoring,
so the LM's moments restore too.

Under ``torchrun`` (one process per device) the ranks join a process group
(:func:`aat_tpu_torch.parallel.distributed.initialize`), the ``--mesh-*``
flags lay them out, each rank reads its data rank's shard of the
training and validation items, and only rank 0 writes checkpoints,
exports, ``data_state.json`` and ``metrics.jsonl``:

    torchrun --nproc-per-node 4 -m aat_tpu_torch.scripts.train --mesh-dp 2 --mesh-fsdp 2 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

from aat_tpu_torch.data.collate import (
    NoSegmentationAudioWaveformCollator,
    TokenizedAudioWaveformCollator,
)
from aat_tpu_torch.data.dataloaders import BatchIterator, duration_key, load_hf_dataset
from aat_tpu_torch.models.build import build_model, build_tokenizer
from aat_tpu_torch.parallel.distributed import initialize, world
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer
from aat_tpu_torch.training import checkpoint as ckpt_lib
from aat_tpu_torch.training.config import (
    TrainingConfig,
    finetuning_lm_config,
    overfit_one_batch_config,
    projection_training_config,
)
from aat_tpu_torch.training.metrics import ComputeMetrics
from aat_tpu_torch.training.optim import tree_leaves
from aat_tpu_torch.training.trainer import (
    AATTrainer,
    AATTrainerSegmentation,
    read_checkpoint_meta,
)
from aat_tpu_torch.utils.tracking import JsonlTracker

logger = logging.getLogger(__name__)

VALIDATION_ITEMS = 30
DATA_STATE_FILE = "data_state.json"


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-t", "--test-run", action="store_true", default=False)
    parser.add_argument("-f", "--finetune", action="store_true", default=False)
    parser.add_argument("-p", "--profile", action="store_true", default=False)
    parser.add_argument("--dataset", default="nguyenvulebinh/asr-alignment")
    parser.add_argument("--pretrained", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--resume-from-checkpoint", default=None)
    for field in dataclasses.fields(TrainingConfig):
        name = "--" + field.name.replace("_", "-")
        if field.type == "bool" or isinstance(field.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction, default=None)
        else:
            parser.add_argument(name, default=None)
    return parser.parse_args(argv)


def cast_like(current, value):
    """A flag's string as the type of the field's current value; a None
    default takes the first of int and float that parses the literal."""
    if isinstance(value, bool) or isinstance(current, bool):
        return bool(value)
    if current is not None:
        return type(current)(value)
    for caster in (int, float):
        try:
            return caster(value)
        except (TypeError, ValueError):
            continue
    return value


def build_config(args) -> TrainingConfig:
    if args.finetune:
        config = finetuning_lm_config()
    elif args.profile:
        config = overfit_one_batch_config()
    else:
        config = projection_training_config()

    if args.test_run:
        config.few_train_samples = 100
        config.few_val_samples = 10
        config.per_device_train_batch_size = 10
        config.num_train_epochs = 2

    for field in dataclasses.fields(TrainingConfig):
        value = getattr(args, field.name, None)
        if value is not None:
            setattr(config, field.name, cast_like(getattr(config, field.name), value))

    config.output_dir = (f"{config.output_dir}_{config.audio_encoder_embeddings_seq_len}"
                         f"_{config.projection_type}_{config.segmentation}")
    return config


def make_collator(config: TrainingConfig, tokenizer):
    """(collator, trainer class) for ``config.segmentation``."""
    if config.segmentation == "none":
        return (NoSegmentationAudioWaveformCollator(tokenizer, add_prefix=config.add_prefix,
                                                    noise_augmentation=True),
                AATTrainer)
    # adaptive training raises the minimum segment to 500 ms; uniform caps
    # segments at max_segment_frames
    audio_tokenizer = AdaptiveAudioTokenizer.create(
        min_segment_duration_milliseconds=500 if config.segmentation == "adaptive" else 125,
        max_segment_duration_milliseconds=config.max_segment_frames * 1000 // config.sampling_rate)
    return (TokenizedAudioWaveformCollator(
        config.audio_encoder_type, config.segmentation, audio_tokenizer, tokenizer,
        n_words=config.n_words, uniform_segmentation_frames_per_segment=config.max_segment_frames,
        add_prefix=config.add_prefix),
        AATTrainerSegmentation)


def _rng(collate):
    return collate.rng.bit_generator


def _restore_data_state(path: str, epoch: int, train_collate, val_collate):
    """Put the collators' generators where the checkpoint's run had them at
    the start of ``epoch``; warn where the checkpoint has no such record."""
    file = os.path.join(path, DATA_STATE_FILE)
    saved = {}
    if os.path.exists(file):
        with open(file) as f:
            saved = json.load(f)
    if saved.get("epoch") != epoch:
        logger.warning("checkpoint %s: no collator state for epoch %d; the resumed run draws "
                       "other noise, crops and prefixes than an uninterrupted run", path, epoch)
        return
    _rng(train_collate).state = saved["train_collator"]
    _rng(val_collate).state = saved["val_collator"]


def run(trainer, config: TrainingConfig, train_iter, val_iter, val_collate, resume=None):
    """The epoch loop: restore once, skip the completed epochs, pin each
    epoch's shuffle, fast-forward the interrupted epoch, then ``finalize``
    and a last checkpoint. Every checkpoint gets the collators' generator
    states (``DATA_STATE_FILE``)."""
    train_collate = train_iter.collate_fn
    steps_per_epoch = len(train_iter) // max(1, config.gradient_accumulation_steps)
    data = {"epoch": 0, "train_collator": _rng(train_collate).state}
    save = trainer.save_checkpoint

    writer = world()[0] == 0

    def save_with_data_state(*args, **kwargs):
        path = save(*args, **kwargs)
        if writer:
            ckpt_lib.write_json(path, DATA_STATE_FILE,
                                {**data, "val_collator": _rng(val_collate).state})
        return path

    trainer.save_checkpoint = save_with_data_state
    start_epoch = 0
    if resume:
        if read_checkpoint_meta(resume).get("train_lm_decoder") and not config.train_lm_decoder:
            # the interrupted run had unfrozen the LM: rebuild the optimizer
            # before restoring, so the LM's moments restore too
            trainer.unfreeze_lm_decoder()
        trainer.restore_checkpoint(resume)
        if steps_per_epoch > 0:
            start_epoch = trainer.state.step // steps_per_epoch
        _restore_data_state(os.path.abspath(resume), start_epoch, train_collate, val_collate)
    for epoch in range(int(config.num_train_epochs)):
        if (config.unfreeze_lm_at_epoch is not None and epoch == config.unfreeze_lm_at_epoch
                and not config.train_lm_decoder):
            trainer.unfreeze_lm_decoder()
        if epoch < start_epoch:
            continue
        train_iter.set_epoch(epoch)
        data.update(epoch=epoch, train_collator=_rng(train_collate).state)
        trainer.train(train_iter, val_iter, fast_forward=bool(resume) and epoch == start_epoch)
        # the epoch's batches are all collated now: a checkpoint of its last
        # step resumes at the next epoch's start
        data.update(epoch=epoch + 1, train_collator=_rng(train_collate).state)
        last = os.path.join(config.output_dir, f"checkpoint-{trainer.state.step}")
        if writer and trainer.state.step == (epoch + 1) * steps_per_epoch and os.path.isdir(last):
            ckpt_lib.write_json(last, DATA_STATE_FILE,
                                {**data, "val_collator": _rng(val_collate).state})
    trainer.finalize()
    trainer.save_checkpoint()


def main(argv=None, device=None):
    args = parse_args(argv)
    config = build_config(args)
    device = initialize(device=device)  # under torchrun: this rank's process group
    writer = world()[0] == 0

    logger.info("building model (pretrained=%s)", args.pretrained)
    model, params = build_model(config, pretrained=args.pretrained,
                                from_pretrained_adapter=config.model_projection_from_pretrained,
                                device=device)
    tokenizer = build_tokenizer(config)
    logger.info("total model parameters: %d", sum(x.numel() for x in tree_leaves(params)))

    dataset = load_hf_dataset(args.dataset, "train")
    val_dataset = load_hf_dataset(args.dataset, "valid")
    val_items = list(val_dataset.select(range(min(VALIDATION_ITEMS, len(val_dataset)))))
    if config.few_train_samples is not None:
        dataset = dataset.select(range(config.few_train_samples))
    items = list(dataset.shuffle(seed=config.seed))

    collate, trainer_cls = make_collator(config, tokenizer)
    val_collate, _ = make_collator(config, tokenizer)
    tracker = (JsonlTracker(os.path.join(config.output_dir, "metrics.jsonl"),
                            project="tokenized_speech_lm") if writer else None)
    trainer = trainer_cls(model, params, config, compute_metrics=ComputeMetrics(tokenizer),
                          tokenizer=tokenizer,
                          log_fn=tracker.log if tracker is not None else lambda metrics: None)
    del params
    # tp and sp peers read the same rows: the shard is the data rank's
    mesh = trainer.mesh
    shard = (dict(shard_index=mesh.data_rank, num_shards=mesh.data_world) if mesh is not None
             else {})
    train_iter = BatchIterator(
        items, collate, config.per_device_train_batch_size, shuffle=True, drop_last=True,
        seed=config.seed, bucket_key=duration_key if config.bucket_by_duration else None,
        bucket_pool_batches=config.bucket_pool_batches, **shard)

    def val_iter():
        return BatchIterator(val_items, val_collate, min(len(val_items), 20), shuffle=False,
                             drop_last=False, is_validation=True, **shard)

    try:
        if args.profile:
            import cProfile

            with cProfile.Profile() as pr:
                run(trainer, config, train_iter, val_iter, val_collate,
                    args.resume_from_checkpoint)
            if writer:
                pr.dump_stats("train_profile.prof")
                logger.info("saved profile: train_profile.prof")
        else:
            run(trainer, config, train_iter, val_iter, val_collate, args.resume_from_checkpoint)
    finally:
        if tracker is not None:
            tracker.finish()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main()
