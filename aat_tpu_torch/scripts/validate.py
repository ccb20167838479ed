"""Validation of an exported adapter (counterpart of
``scripts/validate.py``): build the model with the adapter of
``--checkpoint`` (``build_model(from_pretrained_adapter=...)``), collate
the validation split with the adaptive ``TokenizedAudioWaveformCollator``
and print ``AATTrainerSegmentation.evaluate``'s metrics.

    python -m aat_tpu_torch.scripts.validate --checkpoint <export> \\
        [--dataset <hub-name-or-dir>] [--items 100] [--batch 20] [--no-pretrained]

With ``--pretrained`` (the default) the encoder and the LM are read from
the local checkpoint directories that ``TrainingConfig`` names by default;
the tokenizer needs ``transformers`` and ``--dataset`` needs ``datasets``.
The encoder type is the one the export's ``config.json`` records (JAX's
script takes the default, HuBERT), so an EfficientNet run's export
validates on melspec batches.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from aat_tpu_torch.data.collate import TokenizedAudioWaveformCollator
from aat_tpu_torch.data.dataloaders import BatchIterator, load_hf_dataset
from aat_tpu_torch.models.build import build_model, build_tokenizer
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.metrics import ComputeMetrics
from aat_tpu_torch.training.trainer import AATTrainerSegmentation


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--dataset", default="nguyenvulebinh/asr-alignment")
    parser.add_argument("--items", type=int, default=100)
    parser.add_argument("--batch", type=int, default=20)
    parser.add_argument("--segmentation", default="adaptive")
    parser.add_argument("--projection-type", default="linear")
    parser.add_argument("--pretrained", action=argparse.BooleanOptionalAction, default=True)
    args = parser.parse_args(argv)

    config = TrainingConfig(segmentation=args.segmentation,
                            projection_type=args.projection_type,
                            audio_encoder_type=_recorded_encoder_type(args.checkpoint))
    model, params = build_model(config, pretrained=args.pretrained,
                                from_pretrained_adapter=args.checkpoint, device=device)
    tokenizer = build_tokenizer(config)

    val = load_hf_dataset(args.dataset, "valid")
    val_items = list(val.select(range(min(args.items, len(val)))))
    audio_tokenizer = AdaptiveAudioTokenizer.create(
        min_segment_duration_milliseconds=500,
        max_segment_duration_milliseconds=config.max_segment_frames * 1000 // config.sampling_rate)
    collate = TokenizedAudioWaveformCollator(
        config.audio_encoder_type, config.segmentation, audio_tokenizer, tokenizer,
        uniform_segmentation_frames_per_segment=config.max_segment_frames)
    trainer = AATTrainerSegmentation(model, params, config,
                                     compute_metrics=ComputeMetrics(tokenizer),
                                     tokenizer=tokenizer)
    del params
    batches = BatchIterator(val_items, collate, args.batch, shuffle=False, drop_last=False,
                            is_validation=True)
    metrics = trainer.evaluate(batches)
    print(metrics)
    return metrics


def _recorded_encoder_type(path: str) -> str:
    """The ``audio_encoder_type`` of the export's ``config.json``, else hubert."""
    file = os.path.join(path, "config.json")
    if not os.path.exists(file):
        return "hubert"
    with open(file) as f:
        return json.load(f).get("audio_encoder_type", "hubert")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main()
