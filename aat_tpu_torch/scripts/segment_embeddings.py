"""Offline per-segment HuBERT frame embeddings (counterpart of
``scripts/segment_embeddings.py``).

Each utterance is normalized, tokenized on the host
(:meth:`~aat_tpu_torch.tokenizer.AdaptiveAudioTokenizer.tokenize`), laid
out as a dense ``[n_segments, max_segment_frames]`` batch with a mask and
encoded with HuBERT in eval mode; the valid frames of each segment are
saved as ``segment_<i>`` arrays ``[T_i, E]`` in ``<id>.npz``.

Usage:
    python -m aat_tpu_torch.scripts.segment_embeddings --dataset <hub-name-or-dir> \\
        --out data/audio_segments_embeddings [--encoder facebook/hubert-large-ls960-ft]

The port reads no checkpoints yet: ``--pretrained`` (the default, as in the
JAX script) raises, and ``--random-init`` encodes with the JAX package's
seeded random weights.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aat_tpu_torch.audio import AudioWaveform
from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.ops.mel import normalize_waveform
from aat_tpu_torch.scripts import resolve_device
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer


def load_hf_dataset(path_or_name: str, split: Optional[str] = None):
    """A HF dataset by hub name or from disk (arrow), as the JAX package's
    ``data/dataloaders.load_hf_dataset`` loads it. Needs the ``datasets``
    package and, for hub names, network access."""
    try:
        import datasets
    except ImportError as exc:
        raise RuntimeError("--dataset needs the `datasets` package, which is not "
                           "installed") from exc
    if path_or_name.endswith(".dataset") or path_or_name.endswith("/"):
        return datasets.load_from_disk(path_or_name)
    ds = datasets.load_dataset(path_or_name, "libris")
    return ds[split] if split else ds


def segment_batch(segments: List[AudioWaveform], max_frames: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Segment waveforms → dense ``[S, max_frames]`` f32 batch and int32 mask."""
    batch = np.zeros((len(segments), max_frames), np.float32)
    mask = np.zeros((len(segments), max_frames), np.int32)
    for i, seg in enumerate(segments):
        n = seg.waveform.shape[-1]
        batch[i, :n] = seg.waveform
        mask[i, :n] = 1
    return batch, mask


def encode_segments(params: dict, config: hub.HubertConfig, batch: np.ndarray,
                    mask: np.ndarray, device) -> Dict[str, np.ndarray]:
    """HuBERT (eval mode) over a dense segment batch → the valid frames of
    each segment, ``segment_<i>`` → ``[T_i, E]`` f32."""
    with torch.no_grad():
        frames, frame_mask = hub.hubert_encode(
            params, config, torch.from_numpy(batch).to(device),
            torch.from_numpy(mask).to(device))
    frames = frames.float().cpu().numpy()
    frame_mask = frame_mask.cpu().numpy()
    return {f"segment_{i}": frames[i, frame_mask[i]] for i in range(batch.shape[0])}


def utterance_embeddings(waveform: np.ndarray, tokenizer: AdaptiveAudioTokenizer,
                         params: dict, config: hub.HubertConfig, device
                         ) -> Dict[str, np.ndarray]:
    """One utterance: normalize, tokenize, dense batch, encode."""
    waveform = normalize_waveform(np.asarray(waveform))
    segments, _ = tokenizer.tokenize(AudioWaveform(waveform, tokenizer.sampling_rate))
    batch, mask = segment_batch(segments, tokenizer.max_segment_frames)
    return encode_segments(params, config, batch, mask, device)


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", default="data/audio_segments_embeddings")
    parser.add_argument("--encoder", default="facebook/hubert-large-ls960-ft")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--pretrained", action="store_true", default=True,
                        help="accepted for the JAX command line; pretrained weights "
                             "are the default unless --random-init")
    parser.add_argument("--random-init", action="store_true",
                        help="encode with the JAX package's seeded random weights")
    args = parser.parse_args(argv)

    from aat_tpu_torch.models.build import build_audio_encoder
    from aat_tpu_torch.training.config import TrainingConfig

    device = resolve_device(device)
    cfg = TrainingConfig(audio_encoder_checkpoint=args.encoder)
    params, enc_cfg = build_audio_encoder(cfg, pretrained=not args.random_init,
                                          device=device)
    tokenizer = AdaptiveAudioTokenizer()

    ds = load_hf_dataset(args.dataset, args.split)
    if args.limit:
        ds = ds.select(range(args.limit))
    os.makedirs(args.out, exist_ok=True)
    for item in ds:
        out_path = os.path.join(args.out, str(item["id"]) + ".npz")
        if os.path.exists(out_path):
            continue
        np.savez(out_path, **utterance_embeddings(item["audio"]["array"], tokenizer,
                                                  params, enc_cfg, device))


if __name__ == "__main__":
    main()
