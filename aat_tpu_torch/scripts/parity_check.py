"""Parity harness of the device pipeline against the host-exact numerics
(counterpart of ``scripts/parity_check.py``), on seeded speech-like clips:

  1. mel spectrogram    — the device mel (on the card, the ``csrc/mel.cu``
                          kernel) against the host float64 path;
  2. segment boundaries — the device table against the host-exact spans,
                          which must be identical;
  3. segment embeddings — (``--encoder-check``) bf16 against f32 HuBERT
                          segment means, relative MSE.

With ``--weights <local HF HubertModel/Wav2Vec2Model dir>`` it also reads
that directory through the port's own reader
(:func:`~aat_tpu_torch.utils.port.port_hubert`) and holds it against
``transformers``' model of the same directory:

  4. frame-level parity  — the port's f32 forward on the CPU against the
                           ``transformers`` f32 forward (max abs error
                           below ``--port-threshold``, 2e-4);
  5. segment means       — the port's bf16 encoder on the device against
                           the ``transformers`` f32 oracle on the same
                           host-exact segments (relative MSE below
                           ``--mse-threshold``, 1e-3);
  6. (``--lm-weights <local HF LlamaForCausalLM dir>``) the eval wiring:
     the read encoder and LM in an ASLM with a seeded adapter, beam
     generation and WER/BLEU through ``AATTrainer.evaluate``; the check is
     that it runs and returns a finite WER.

Usage:
    python -m aat_tpu_torch.scripts.parity_check [--clips 8] [--seconds 6] \\
        [--encoder-check] [--weights <dir> [--lm-weights <dir>]] [--cpu]

It runs on ``cuda:0`` unless ``--cpu`` (or ``main(..., device=...)``) says
otherwise. Exit code 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.ops.mel import log_mel_spectrogram_exact, normalize_waveform
from aat_tpu_torch.ops.ragged import masked_mean
from aat_tpu_torch.runtime.device import resolve_device
from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer
from aat_tpu_torch.training.optim import tree_map


def make_speechlike(rng: np.random.Generator, seconds: float, sr: int = 16000) -> np.ndarray:
    """Hann-windowed bursts of noise and a 220 Hz tone with pauses between
    them, plus a little noise (the JAX script's clips, draw for draw)."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = np.zeros(n)
    pos = 0
    while pos < n:
        burst = int(rng.uniform(0.15, 0.6) * sr)
        gap = int(rng.uniform(0.05, 0.3) * sr)
        env[pos : pos + burst] = np.hanning(max(burst, 2))[:burst][: max(n - pos, 0)]
        pos += burst + gap
    w = env * (rng.normal(0, 1, n) * 0.5 + 0.3 * np.sin(2 * np.pi * 220 * t))
    return w + rng.normal(0, 1e-4, n)


# the files of a saved HF tokenizer, one of which a directory must hold
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json")


class _WordTokenizer:
    """Word-level stand-in for an HF tokenizer, used only when the
    ``--lm-weights`` directory has no tokenizer files (the JAX script
    falls back to it when ``AutoTokenizer`` raises)."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self.vocab = {"<pad>": 0, "<s>": 1, "</s>": 2}

    def _id(self, w):
        if w not in self.vocab:
            self.vocab[w] = len(self.vocab)
        return self.vocab[w]

    def decode(self, ids):
        rev = {v: k for k, v in self.vocab.items()}
        return " ".join(rev.get(int(i), "?") for i in ids)

    def batch_decode(self, ids_batch, skip_special_tokens=True):
        rev = {v: k for k, v in self.vocab.items()}
        out = []
        for ids in ids_batch:
            words = [rev.get(int(i), "") for i in ids]
            if skip_special_tokens:
                words = [w for w in words if w not in ("<s>", "</s>", "<pad>", "")]
            out.append(" ".join(words))
        return out

    def __call__(self, texts, padding=True):
        seqs = []
        for t in texts:
            t = t.replace("<s>", " <s> ").replace("</s>", " </s> ")
            seqs.append([self._id(w) for w in t.split()])
        max_len = max(len(s) for s in seqs)
        ids = np.zeros((len(seqs), max_len), np.int64)
        mask = np.zeros((len(seqs), max_len), np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def check_boundaries(tok: AdaptiveAudioTokenizer, clips: int, seconds: float, device) -> int:
    """Checks 1-2 over ``clips`` clips of ``seconds + i % 3`` seconds;
    returns the number of boundary mismatches."""
    failures = 0
    for i in range(clips):
        w = normalize_waveform(make_speechlike(np.random.default_rng(i), seconds + i % 3))
        exact = log_mel_spectrogram_exact(w)
        with torch.no_grad():
            out = tok.tokenize_batch(
                torch.from_numpy(w[None].astype(np.float32)).to(device),
                torch.tensor([w.size], dtype=torch.int32, device=device))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        t_valid = w.size // 160 + 1
        mel_max_err = float(np.abs(out["melspec"][0, :, :t_valid] - exact).max())
        host_spans = tok.segment_spans(w)[0]
        n = int(out["num_segments"][0])
        device_spans = [(int(out["starts"][0, j]), int(out["ends"][0, j]),
                         int(out["out_lens"][0, j])) for j in range(n)]
        ok = device_spans == host_spans
        failures += not ok
        print(f"clip {i}: boundaries {'OK' if ok else 'MISMATCH'} ({n} segments), "
              f"mel max |err| {mel_max_err:.2e}", flush=True)
        if not ok:
            first = next((j for j, (a, b) in enumerate(zip(device_spans, host_spans)) if a != b),
                         min(len(device_spans), len(host_spans)))
            print(f"clip {i}: first differing span {first}: device "
                  f"{device_spans[first:first + 1]} host {host_spans[first:first + 1]} "
                  f"({len(device_spans)} vs {len(host_spans)} spans)", flush=True)
    return failures


def encoder_check(device, threshold: float) -> int:
    """Check 3: hubert-large (seeded random weights) segment means in bf16
    against f32 on 8 segments of 4000 samples."""
    cfg = hub.hubert_large_config()
    params = hub.init_hubert_params(0, cfg, device)
    params_bf16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    seg = torch.from_numpy(
        np.random.default_rng(0).normal(0, 0.5, (8, 4000)).astype(np.float32)).to(device)
    mask = torch.ones((8, 4000), dtype=torch.int32, device=device)

    def means(p, dtype):
        with torch.no_grad():
            frames, fm = hub.hubert_encode(p, cfg, seg.to(dtype), mask)
            return masked_mean(frames.float(), fm).cpu().numpy()

    m32, m16 = means(params, torch.float32), means(params_bf16, torch.bfloat16)
    rel_mse = float(np.mean((m32 - m16) ** 2) / np.mean(m32 ** 2))
    ok = rel_mse < threshold
    print(f"encoder bf16-vs-f32 segment-mean relative MSE: {rel_mse:.2e} "
          f"({'OK' if ok else 'FAIL'} @ {threshold})", flush=True)
    return int(not ok)


def run_weights_parity(args, tok: AdaptiveAudioTokenizer, device) -> int:
    """Checks 4-6 on a local HF checkpoint directory; returns the number of
    failures. oneDNN is off throughout, as the JAX script turns it off: its
    bf16 fast math on the CPU breaks the oracle (and a grouped bf16 conv on
    the CPU, the positional conv, errs by more than its output's norm)."""
    with torch.backends.mkldnn.flags(enabled=False):
        return _weights_parity(args, tok, device)


def _weights_parity(args, tok: AdaptiveAudioTokenizer, device) -> int:
    import transformers

    from aat_tpu_torch.utils.port import port_hubert

    failures = 0
    cls = (transformers.Wav2Vec2Model if args.encoder_type == "wav2vec2"
           else transformers.HubertModel)
    tm = cls.from_pretrained(args.weights, mask_time_prob=0.0, local_files_only=True).eval()
    params, cfg = port_hubert(args.weights, args.encoder_type)
    print(f"ported {args.weights}: hidden={cfg.hidden_size} "
          f"layers={cfg.num_hidden_layers} conv={cfg.conv_dim}", flush=True)

    # 4: frame-level parity, f32 against the transformers f32 forward, both
    # on the CPU
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.normal(0, 0.5, (2, 6400)).astype(np.float32))
    mask = torch.ones((2, 6400), dtype=torch.int64)
    mask[1, 4000:] = 0
    with torch.no_grad():
        ref_frames = tm(wav, attention_mask=mask).last_hidden_state.numpy()
        ours, fm = hub.hubert_encode(params, cfg, wav, mask)
    diff = float(np.abs(ours.numpy() - ref_frames)[fm.numpy()].max())
    ok = diff < args.port_threshold
    failures += not ok
    print(f"port parity (f32 frames): max |err| {diff:.2e} "
          f"({'OK' if ok else 'FAIL'} @ {args.port_threshold})", flush=True)

    # 5: the bf16 device encoder against the transformers f32 oracle on the
    # same host-exact segments
    segs = []
    for i in range(args.weights_clips):
        w = normalize_waveform(
            make_speechlike(np.random.default_rng(100 + i), args.seconds)).astype(np.float32)
        for start, end, out_len in tok.segment_spans(w)[0]:
            piece = np.zeros(out_len, np.float32)
            piece[: end - start] = w[start:end]
            segs.append(piece)
    max_len = max(s.size for s in segs)
    batch = np.zeros((len(segs), max_len), np.float32)
    smask = np.zeros((len(segs), max_len), np.int64)
    for i, s in enumerate(segs):
        batch[i, : s.size] = s
        smask[i, : s.size] = 1
    with torch.no_grad():
        tref = tm(torch.from_numpy(batch),
                  attention_mask=torch.from_numpy(smask)).last_hidden_state.numpy()
    del tm
    device_cfg = dataclasses.replace(cfg, attention_impl="pallas")
    params_bf16 = tree_map(lambda x: x.to(device, torch.bfloat16), params)
    with torch.no_grad():
        frames16, fm16 = hub.hubert_encode(
            params_bf16, device_cfg, torch.from_numpy(batch).to(device, torch.bfloat16),
            torch.from_numpy(smask).to(device))
        means16 = masked_mean(frames16.float(), fm16).cpu().numpy().astype(np.float64)
    fmask = fm16.cpu().numpy().astype(np.float64)
    ref_means = (tref * fmask[..., None]).sum(1) / fmask.sum(1, keepdims=True)
    rel_mse = float(np.mean((means16 - ref_means) ** 2) / np.mean(ref_means ** 2))
    ok = rel_mse < args.mse_threshold
    failures += not ok
    print(f"pipeline segment means ({len(segs)} segments, bf16 device path "
          f"vs transformers f32): relative MSE {rel_mse:.2e} "
          f"({'OK' if ok else 'FAIL'} @ {args.mse_threshold})", flush=True)

    if args.lm_weights:
        failures += run_eval_wiring(args, tree_map(lambda x: x.to(device), params),
                                    device_cfg, device)
    return failures


def run_eval_wiring(args, enc_params: dict, enc_cfg: hub.HubertConfig, device) -> int:
    """Check 6: the read encoder and LM in an ASLM with a seeded adapter,
    through ``AATTrainerSegmentation.evaluate`` (beam generation, WER,
    BLEU, ROUGE, METEOR) on 2 seeded items; the metrics mean nothing
    without a trained adapter, the check is a finite WER."""
    import transformers

    from aat_tpu_torch.data.collate import TokenizedAudioWaveformCollator
    from aat_tpu_torch.data.dataloaders import BatchIterator
    from aat_tpu_torch.models.aslm import AslmConfig, AslmModel, init_aslm_params
    from aat_tpu_torch.training.config import TrainingConfig
    from aat_tpu_torch.training.metrics import ComputeMetrics
    from aat_tpu_torch.training.trainer import AATTrainerSegmentation
    from aat_tpu_torch.utils.port import port_llama

    lm_params, lm_cfg = port_llama(args.lm_weights)
    lm_cfg = dataclasses.replace(lm_cfg, attention_impl="pallas")
    print(f"ported {args.lm_weights}: hidden={lm_cfg.hidden_size} "
          f"layers={lm_cfg.num_hidden_layers} vocab={lm_cfg.vocab_size}", flush=True)
    if any(os.path.exists(os.path.join(args.lm_weights, f)) for f in TOKENIZER_FILES):
        tokenizer = transformers.AutoTokenizer.from_pretrained(args.lm_weights,
                                                               local_files_only=True)
        tokenizer.add_bos_token = True
        tokenizer.add_eos_token = True
    else:
        print(f"no tokenizer files in {args.lm_weights}; using the word-level stand-in "
              "for the wiring check", flush=True)
        tokenizer = _WordTokenizer()

    tcfg = TrainingConfig(segmentation="adaptive", eval_steps=0, save_steps=0)
    aslm_cfg = AslmConfig(projection_type=tcfg.projection_type,
                          audio_encoder_embeddings_seq_len=tcfg.audio_encoder_embeddings_seq_len,
                          audio_encoder_hidden=enc_cfg.hidden_size, lm_hidden=lm_cfg.hidden_size)
    model = AslmModel(aslm_cfg, enc_cfg, lm_cfg)
    params = {"audio_encoder": enc_params,
              "adapter": init_aslm_params((0, 0), aslm_cfg, device),  # PRNGKey(0)'s data
              "lm_decoder": tree_map(lambda x: x.to(device), lm_params)}
    trainer = AATTrainerSegmentation(model, params, tcfg, compute_metrics=ComputeMetrics(tokenizer),
                                     tokenizer=tokenizer)
    audio_tok = AdaptiveAudioTokenizer.create(
        min_segment_duration_milliseconds=500,
        max_segment_duration_milliseconds=tcfg.max_segment_frames * 1000 // tcfg.sampling_rate)
    collate = TokenizedAudioWaveformCollator(
        tcfg.audio_encoder_type, tcfg.segmentation, audio_tok, tokenizer,
        uniform_segmentation_frames_per_segment=tcfg.max_segment_frames)
    items = []
    for i in range(2):
        w = make_speechlike(np.random.default_rng(200 + i), 2.0)
        n_words = 6
        starts = np.linspace(0, 1.8, n_words)
        items.append({"id": f"parity-{i}", "audio": {"array": w, "sampling_rate": 16000},
                      "words": [f"word{j}" for j in range(n_words)],
                      "word_start": starts.tolist(), "word_end": (starts + 0.15).tolist()})
    batches = BatchIterator(items, collate, 2, shuffle=False, drop_last=False,
                            is_validation=True)
    metrics = trainer.evaluate(batches)
    wer = metrics.get("eval/wer", metrics.get("wer"))
    ok = wer is not None and np.isfinite(float(wer))
    print(f"eval wiring (read encoder + LM, beam generation): "
          f"{ {k: round(float(v), 4) for k, v in metrics.items()} } "
          f"({'OK' if ok else 'FAIL'})", flush=True)
    return int(not ok)


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--mse-threshold", type=float, default=1e-3)
    parser.add_argument("--encoder-check", action="store_true",
                        help="also compare bf16 vs f32 HuBERT segment means")
    parser.add_argument("--weights", default=None,
                        help="local HF HubertModel/Wav2Vec2Model dir: read it with the "
                             "port's reader and check frames and segment means")
    parser.add_argument("--lm-weights", default=None,
                        help="local HF LlamaForCausalLM dir: also run the eval wiring")
    parser.add_argument("--encoder-type", default="hubert", choices=("hubert", "wav2vec2"))
    parser.add_argument("--port-threshold", type=float, default=2e-4)
    parser.add_argument("--weights-clips", type=int, default=2,
                        help="clips for the segment-mean MSE check")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else device)
    tok = AdaptiveAudioTokenizer()
    failures = check_boundaries(tok, args.clips, args.seconds, device)
    if args.encoder_check:
        failures += encoder_check(device, args.mse_threshold)
    if args.weights:
        failures += run_weights_parity(args, tok, device)
    print("PARITY:", "PASS" if failures == 0 else f"FAIL ({failures})", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
