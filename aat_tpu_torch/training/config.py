"""Typed training configuration (counterpart of
``aat_tpu/training/config.py``): the same fields, defaults and preset
factories. The ``mesh_*`` fields lay the ranks of an initialized process
group out as the trainer's mesh (:mod:`aat_tpu_torch.parallel.mesh`);
the trainer refuses ``mesh_pp > 1`` (ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

@dataclasses.dataclass
class TrainingConfig:
    # run
    output_dir: str = "data/models/aslm_experiments"
    seed: int = 42

    # batch / schedule (reference trainer.py:50-69)
    per_device_train_batch_size: int = 40
    gradient_accumulation_steps: int = 2
    num_train_epochs: int = 3
    learning_rate: float = 1e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    max_steps: Optional[int] = None
    start_lr_from: float = 1e-5  # reference lr_scheduler.py:12
    eval_steps: int = 1000
    save_steps: int = 1000
    save_total_limit: int = 2
    logging_steps: int = 25
    optimizer: str = "adamw"  # adamw | adafactor
    # reference trainer.py:63: load_best_model_at_end=True on eval loss
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "eval/loss"
    greater_is_better: bool = False

    # model / freezing (reference trainer.py:71-83)
    segmentation: str = "none"  # none | uniform | adaptive
    train_audio_encoder: bool = True
    train_lm_decoder: bool = False
    audio_encoder_type: str = "hubert"  # hubert | wav2vec2 | efficient_net
    audio_encoder_checkpoint: str = "facebook/hubert-large-ls960-ft"
    lm_pretrained_model: str = "HuggingFaceTB/SmolLM-135M-Instruct"
    projection_type: str = "linear"
    audio_encoder_embeddings_seq_len: int = 1
    max_segment_frames: int = 4000
    n_words: Optional[int] = None
    model_projection_from_pretrained: Optional[str] = None
    unfreeze_lm_at_epoch: Optional[int] = None  # reference config.py:44
    # EarlyStoppingCallback(patience=20, threshold=0.01) is constructed but
    # commented out in the reference (trainer_train.py:69-72); here it is a
    # working opt-in.
    early_stopping_patience: Optional[int] = None
    early_stopping_threshold: float = 0.01

    # data (reference config.py:46-57)
    sampling_rate: int = 16000
    few_train_samples: Optional[int] = None
    few_val_samples: int = 100
    add_prefix: bool = True
    noise_augmentation: bool = False
    # length-bucketed batching (a data-loader knob, kept for field parity)
    bucket_by_duration: bool = False
    bucket_pool_batches: int = 50
    train_dataset_path: Optional[str] = None
    validation_dataset_path: Optional[str] = None

    # on-device datagen: raw waveforms segmented inside the train step
    max_on_device_segments: int = 64

    # failure containment: skip optimizer updates on non-finite loss
    skip_nonfinite_updates: bool = True

    # numerics / parallelism
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # sequence packing for the LM decoder: fold this many utterance rows
    # into each decoder row (block-diagonal attention, per-utterance rotary
    # positions — models/aslm.py:forward). Loss-equivalent to unpacked.
    lm_pack: int = 1
    # encoder-layer rematerialization (models/build puts it on the
    # HubertConfig): 'full' recomputes each layer in the backward, 'dots'
    # keeps the matrix-product outputs
    encoder_remat: bool = False
    encoder_remat_policy: str = "full"  # 'full' | 'dots'
    mesh_dp: int = 1
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    mesh_sp: int = 1
    mesh_pp: int = 1
    pp_microbatches: int = 0  # 0 → 2 * mesh_pp
    grad_clip_norm: Optional[float] = None

    def __post_init__(self):
        if (
            self.train_dataset_path is not None
            and self.train_dataset_path == self.validation_dataset_path
        ):
            # reference validate_different_datasets (config.py:59-62)
            raise ValueError("Datasets must not be the same for validation and train")
        if self.encoder_remat_policy not in ("full", "dots"):
            raise ValueError(
                f"encoder_remat_policy must be 'full' or 'dots', got "
                f"{self.encoder_remat_policy!r}")


def overfit_one_batch_config() -> TrainingConfig:
    """Parity with overfit_one_batch_train_config (config.py:65-87)."""
    return TrainingConfig(
        few_train_samples=100,
        few_val_samples=8,
        n_words=50,
        per_device_train_batch_size=10,
        gradient_accumulation_steps=1,
        num_train_epochs=10,
        projection_type="linear",
    )


def projection_training_config() -> TrainingConfig:
    """Parity with projection_training (config.py:90-113)."""
    return TrainingConfig(
        few_train_samples=None,
        few_val_samples=100,
        n_words=50,
        projection_type="linear",
        train_audio_encoder=True,
        train_lm_decoder=False,
    )


def finetuning_lm_config() -> TrainingConfig:
    """Parity with finetuning_lm + the -f CLI overrides
    (config.py:115-138, trainer_train.py:289-294)."""
    return TrainingConfig(
        few_train_samples=None,
        few_val_samples=1000,
        n_words=50,
        num_train_epochs=1,
        per_device_train_batch_size=20,
        gradient_accumulation_steps=5,
        eval_steps=300,
        train_lm_decoder=True,
    )
