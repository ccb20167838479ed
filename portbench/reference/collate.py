"""The whole-utterance batches of a training run, worked out again from the
raw items: the batch order of a seeded shuffle, and for each item the
noise and the prompt drawn from one generator in the data layer's order
(the waveform's noise, then its scale, then the prompt), the per-utterance
zero-mean unit-variance normalization, and the captions through the
benchmark's tokenizer. A plain restatement of the data layer's published
behaviour, for the reference; it imports nothing of the program."""

from __future__ import annotations

from typing import List

import numpy as np

PREFIXES = [
    "The audio transcription states:",
    "According to the audio transcript:",
    "As per the audio transcription:",
    "In the audio recording it is said:",
    "Based on the audio script:",
    "Per the audio record:",
    "From the audio file it can be heard:",
    "What the audio text conveys is:",
    "Transcribed from the audio:",
    "Listening to the recording reveals:",
]


def batch_order(n_items: int, batch_size: int, shuffle_seed: int, n_batches: int) -> List[np.ndarray]:
    """The item indices of the first ``n_batches`` batches, epoch after
    epoch (each shuffled by ``shuffle_seed + epoch``, its last partial batch
    dropped)."""
    out, epoch = [], 0
    while len(out) < n_batches:
        idx = np.arange(n_items)
        np.random.default_rng(shuffle_seed + epoch).shuffle(idx)
        out += [idx[i: i + batch_size] for i in range(0, n_items - batch_size + 1, batch_size)]
        epoch += 1
    return out[:n_batches]


def collate_batches(items, batches, tokenizer, collate_seed: int, noise: bool = True,
                    add_prefix: bool = True) -> List[dict]:
    """The collated batches, in order, from one generator."""
    rng = np.random.default_rng(collate_seed)
    bos = tokenizer.decode([tokenizer.bos_token_id])
    eos = tokenizer.decode([tokenizer.eos_token_id])
    out = []
    for chunk in batches:
        texts, waves = [], []
        for i in chunk:
            item = items[int(i)]
            w = np.asarray(item["audio"]["array"], dtype=np.float64)
            if noise:
                w = w + rng.random(w.shape[-1]) * (int(rng.integers(1, 51)) / 1000)
            prefix = ""
            if add_prefix:
                prefix = PREFIXES[int(rng.integers(0, len(PREFIXES)))] + " "
            texts.append(bos + prefix + " ".join(item["words"]) + eos)
            waves.append(w)
        tok = tokenizer(texts, padding=True)
        length = max(w.size for w in waves)
        x = np.zeros((len(waves), length), np.float32)
        m = np.zeros((len(waves), length), np.int64)
        for r, w in enumerate(waves):
            x[r, : w.size] = (w - w.mean()) / np.sqrt(w.var() + 1e-7)
            m[r, : w.size] = 1
        ids = np.asarray(tok["input_ids"])
        cmask = np.asarray(tok["attention_mask"])
        out.append({"waveforms": x, "waveforms_attention_mask": m, "input_ids": ids,
                    "attention_mask": cmask, "input_ids_attention_mask": cmask})
    return out
