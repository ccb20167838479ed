"""Speech-to-text serving from an export (counterpart of
``scripts/serve.py``): load an ``AATTrainer.save_pretrained`` export
(:func:`~aat_tpu_torch.models.build.load_pretrained`), segment each
utterance on the device (adaptive amplitude tokenizer), encode the
segments and decode captions through the continuous-batching engine
(:func:`~aat_tpu_torch.serving.serve.serve`).

    python -m aat_tpu_torch.scripts.serve --model-dir <export> --audio a.npy b.wav
    python -m aat_tpu_torch.scripts.serve --model-dir <export> --random-demo 4

Audio inputs: ``.npy`` (a float waveform at 16 kHz) or ``.wav`` (PCM, read
with scipy). The tokenizer of the export's ``lm_pretrained_model`` decodes
the ids when ``transformers`` and a local copy are there; otherwise each
transcript prints as token ids. One JSON line per utterance.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np

from aat_tpu_torch.models.build import load_pretrained
from aat_tpu_torch.ops.mel import SAMPLING_RATE
from aat_tpu_torch.serving import serve


def load_waveform(path: str, sampling_rate: int) -> np.ndarray:
    if path.endswith(".npy"):
        w = np.load(path)
    elif path.endswith(".wav"):
        from scipy.io import wavfile

        sr, w = wavfile.read(path)
        if sr != sampling_rate:
            raise ValueError(f"{path}: sampling rate {sr}, expected {sampling_rate}")
        if w.dtype.kind == "i":
            w = w.astype(np.float32) / np.iinfo(w.dtype).max
    else:
        raise ValueError(f"unsupported audio format: {path}")
    return np.asarray(w, np.float32).reshape(-1)


def demo_waves(n: int, sampling_rate: int = SAMPLING_RATE) -> List[np.ndarray]:
    """``n`` synthetic utterances of 1-3 s (Gaussian noise, seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.normal(0, 0.3, rng.integers(sampling_rate, 3 * sampling_rate)).astype(np.float32)
            for _ in range(n)]


def local_tokenizer(name: str):
    """The export's tokenizer from local files, or None (ids are printed)."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name, local_files_only=True)
    except Exception as exc:  # noqa: BLE001 — no transformers or no local copy: ids only
        print(f"# tokenizer unavailable ({type(exc).__name__}); printing ids", file=sys.stderr)
        return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--audio", nargs="*", default=[])
    ap.add_argument("--random-demo", type=int, default=0,
                    help="serve N synthetic utterances (no audio files)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--max-segments", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8, help="decode steps per dispatch (run_steps)")
    ap.add_argument("--sampling-rate", type=int, default=SAMPLING_RATE)
    ap.add_argument("--max-segment-frames", type=int, default=4000,
                    help="250 ms at 16 kHz (reference max_segment_frames)")
    ap.add_argument("--eos-token-id", type=int, default=2,
                    help="used when the tokenizer cannot be loaded")
    args = ap.parse_args(argv)
    if args.sampling_rate != SAMPLING_RATE:
        ap.error(f"the mel front end runs at {SAMPLING_RATE} Hz")
    if not args.audio and not args.random_demo:
        ap.error("provide --audio files or --random-demo N")
    return args


def serve_config(args, eos_token_id: int) -> serve.ServeConfig:
    return serve.ServeConfig(segmentation="adaptive", max_slots=args.max_slots,
                             max_new_tokens=args.max_new_tokens, max_segments=args.max_segments,
                             chunk=args.chunk, max_segment_frames=args.max_segment_frames,
                             eos_token_id=eos_token_id)


def main(argv=None, device=None):
    args = parse_args(argv)
    model, params = load_pretrained(args.model_dir, device=device)
    with open(os.path.join(args.model_dir, "config.json")) as f:
        desc = json.load(f)
    tokenizer = local_tokenizer(desc["lm_pretrained_model"])

    if args.random_demo:
        waves = demo_waves(args.random_demo, args.sampling_rate)
        names = [f"demo-{i}" for i in range(args.random_demo)]
    else:
        waves = [load_waveform(p, args.sampling_rate) for p in args.audio]
        names = list(args.audio)
    eos = tokenizer.eos_token_id if tokenizer is not None else args.eos_token_id
    results = serve.serve(model, params, waves, serve_config(args, eos))

    for name, ids in zip(names, results):
        ids = ids.tolist()
        if tokenizer is not None:
            cut = ids[: ids.index(eos)] if eos in ids else ids
            print(json.dumps({"audio": name,
                              "text": tokenizer.decode(cut, skip_special_tokens=True)}))
        else:
            print(json.dumps({"audio": name, "ids": ids}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
