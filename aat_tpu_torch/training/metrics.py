"""Evaluation metrics (a copy of ``aat_tpu/training/metrics.py``, which the
port does not import): WER, BLEU, ROUGE-1/2/L/Lsum, METEOR.

Capability parity with the reference's ``ComputeMetrics``, which wraps the
``evaluate`` library. That library is not available, so the metrics are
implemented natively, in pure Python:

- WER: corpus-level word edit distance / total reference words (jiwer
  semantics).
- BLEU: corpus BLEU, 4-gram, exp brevity penalty (the evaluate "bleu"
  metric's algorithm), reported ×100 like the reference.
- ROUGE-1/2: n-gram F1; ROUGE-L: LCS F1; ROUGE-Lsum: LCS over
  newline-split sentences (rouge_score semantics, no stemmer).
- METEOR: exact-match alignment with the standard harmonic-mean +
  fragmentation penalty (alpha=0.9, beta=3, gamma=0.5), then Porter stems
  and WordNet synonyms where ``nltk`` and its corpus data are present
  (imported lazily; without them the stage is skipped, and the metrics
  dict says so).

Text normalization mirrors the reference exactly: decode, strip prefix from
references, newline→space, strip, lowercase.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Normalization (reference compute_metrics.py:43-70)
# ---------------------------------------------------------------------------


def normalize_text(sentence: str) -> str:
    sentence = sentence.replace("\n", " ")
    sentence = sentence.strip()
    sentence = sentence.rstrip()
    return sentence.lower()


def strip_prefix(reference: str, prefix: str) -> str:
    return reference[len(prefix):]


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------


def _edit_distance(a: Sequence[str], b: Sequence[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


def wer(predictions: List[str], references: List[str]) -> float:
    """Corpus WER: sum of word edit distances / total reference words.

    Words become ids of one vocabulary, and the distance of two id
    sequences is :func:`~aat_tpu_torch.runtime.host_ops.edit_distance`
    (the native library's where it is built, as in JAX)."""
    from aat_tpu_torch.runtime.host_ops import edit_distance

    vocab: dict = {}

    def ids(words):
        return np.array([vocab.setdefault(w, len(vocab)) for w in words], dtype=np.int64)

    total_dist = 0
    total_words = 0
    for pred, ref in zip(predictions, references):
        pred_words, ref_words = pred.split(), ref.split()
        total_dist += edit_distance(ids(pred_words), ids(ref_words))
        total_words += len(ref_words)
    return total_dist / max(total_words, 1)


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    predictions: List[str],
    references: List[List[str]],
    max_order: int = 4,
    smooth: bool = False,
) -> float:
    """Corpus BLEU (Papineni et al.; the evaluate 'bleu' algorithm)."""
    import math

    matches = [0] * max_order
    possible = [0] * max_order
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(predictions, references):
        p = pred.split()
        rs = [r.split() for r in refs]
        pred_len += len(p)
        ref_len += min((abs(len(r) - len(p)), len(r)) for r in rs)[1]
        for n in range(1, max_order + 1):
            pred_ng = _ngrams(p, n)
            max_ref = Counter()
            for r in rs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            overlap = sum(min(c, max_ref[ng]) for ng, c in pred_ng.items())
            matches[n - 1] += overlap
            possible[n - 1] += max(len(p) - n + 1, 0)

    precisions = []
    for n in range(max_order):
        if smooth:
            precisions.append((matches[n] + 1.0) / (possible[n] + 1.0))
        elif possible[n] > 0:
            precisions.append(matches[n] / possible[n])
        else:
            precisions.append(0.0)
    if min(precisions) <= 0:
        return 0.0
    geo = math.exp(sum(math.log(p) for p in precisions) / max_order)
    ratio = pred_len / max(ref_len, 1)
    bp = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / ratio) if ratio > 0 else 0.0
    return geo * bp


# ---------------------------------------------------------------------------
# ROUGE
# ---------------------------------------------------------------------------


def _f1(p: float, r: float) -> float:
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def _rouge_n(pred: Sequence[str], ref: Sequence[str], n: int) -> float:
    pred_ng, ref_ng = _ngrams(pred, n), _ngrams(ref, n)
    overlap = sum(min(c, ref_ng[ng]) for ng, c in pred_ng.items())
    p = overlap / max(sum(pred_ng.values()), 1)
    r = overlap / max(sum(ref_ng.values()), 1)
    return _f1(p, r)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _rouge_l(pred: Sequence[str], ref: Sequence[str]) -> float:
    lcs = _lcs_len(pred, ref)
    p = lcs / max(len(pred), 1)
    r = lcs / max(len(ref), 1)
    return _f1(p, r)


def _union_lcs(pred_sents: List[List[str]], ref_sents: List[List[str]]) -> float:
    """rougeLsum: summary-level LCS (rouge_score semantics)."""
    pred_len = sum(len(s) for s in pred_sents)
    ref_len = sum(len(s) for s in ref_sents)
    hits = 0
    for r in ref_sents:
        lcs_union: set = set()
        for p in pred_sents:
            # token positions in r that participate in the LCS with p
            lcs_union |= _lcs_positions(r, p)
        hits += len(lcs_union)
    prec = hits / max(pred_len, 1)
    rec = hits / max(ref_len, 1)
    return _f1(prec, rec)


def _lcs_positions(r: Sequence[str], p: Sequence[str]) -> set:
    if not r or not p:
        return set()
    dp = [[0] * (len(p) + 1) for _ in range(len(r) + 1)]
    for i in range(1, len(r) + 1):
        for j in range(1, len(p) + 1):
            dp[i][j] = dp[i - 1][j - 1] + 1 if r[i - 1] == p[j - 1] else max(
                dp[i - 1][j], dp[i][j - 1]
            )
    pos = set()
    i, j = len(r), len(p)
    while i > 0 and j > 0:
        if r[i - 1] == p[j - 1] and dp[i][j] == dp[i - 1][j - 1] + 1:
            pos.add(i - 1)
            i, j = i - 1, j - 1
        elif dp[i - 1][j] >= dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return pos


def rouge(predictions: List[str], references: List[str]) -> Dict[str, float]:
    r1, r2, rl, rlsum = [], [], [], []
    for pred, ref in zip(predictions, references):
        p, r = pred.split(), ref.split()
        r1.append(_rouge_n(p, r, 1))
        r2.append(_rouge_n(p, r, 2))
        rl.append(_rouge_l(p, r))
        pred_sents = [s.split() for s in pred.split("\n") if s.split()]
        ref_sents = [s.split() for s in ref.split("\n") if s.split()]
        rlsum.append(_union_lcs(pred_sents or [p], ref_sents or [r]))
    n = max(len(predictions), 1)
    return {
        "rouge1": sum(r1) / n,
        "rouge2": sum(r2) / n,
        "rougeL": sum(rl) / n,
        "rougeLsum": sum(rlsum) / n,
    }


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------
#
# Mirrors nltk.translate.meteor_score (the engine behind the `evaluate`
# library's meteor the reference reports, compute_metrics.py:102-112):
# staged greedy alignment — exact words, then Porter stems, then WordNet
# synonyms — scored with alpha=0.9, beta=3, gamma=0.5. The stemmer comes
# from nltk when installed (pure code, no data download); the synonym stage
# runs only when the WordNet corpus data is actually present (it is not in
# offline environments), otherwise that stage is skipped and scores can
# differ from nltk's by the synonym matches only.


def _porter_stemmer():
    try:
        from nltk.stem.porter import PorterStemmer

        return PorterStemmer().stem
    except ImportError:  # identity fallback keeps METEOR functional
        return lambda w: w


def _wordnet_or_none():
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("dog")  # raises LookupError without the corpus data
        return wordnet
    except Exception:
        return None


_STEM = None
_WORDNET: object = "unset"


def _meteor_backends():
    global _STEM, _WORDNET
    if _STEM is None:
        _STEM = _porter_stemmer()
    if _WORDNET == "unset":
        _WORDNET = _wordnet_or_none()
        if _WORDNET is None:
            import logging

            # disclosed once at scoring time, not buried in a comment:
            # scores can differ from the reference's by synonym matches
            logging.getLogger(__name__).warning(
                "METEOR: WordNet corpus data unavailable — synonym stage "
                "skipped; scores may differ from nltk/evaluate METEOR by "
                "synonym-only matches"
            )
    return _STEM, _WORDNET


def _align(pred: List[str], ref: List[str]):
    """nltk _enum_align_words: greedy first-fit matching in three stages
    over the words left unmatched by the previous stage."""
    stem, wordnet = _meteor_backends()
    hyp = list(enumerate(pred))
    rem_ref = list(enumerate(ref))
    pairs = []

    def stage(match_fn):
        nonlocal hyp, rem_ref
        keep = []
        for i, w in hyp:
            hit = None
            for idx, (j, v) in enumerate(rem_ref):
                if match_fn(w, v):
                    hit = idx
                    break
            if hit is None:
                keep.append((i, w))
            else:
                pairs.append((i, rem_ref[hit][0]))
                del rem_ref[hit]
        hyp = keep

    stage(lambda w, v: w == v)
    stage(lambda w, v: stem(w) == stem(v))
    if wordnet is not None:
        from itertools import chain

        def synonyms(word):
            return set(
                chain.from_iterable(
                    (lemma.name() for lemma in synset.lemmas()
                     if lemma.name().find("_") < 0)
                    for synset in wordnet.synsets(word)
                )
            ).union({word})

        stage(lambda w, v: v in synonyms(w))
    return sorted(pairs)


def _meteor_single(pred: List[str], ref: List[str]) -> float:
    pairs = _align(pred, ref)
    m = len(pairs)
    if m == 0:
        return 0.0
    precision = m / len(pred)
    recall = m / len(ref)
    fmean = precision * recall / (0.9 * precision + 0.1 * recall)
    # fragmentation: count chunks of contiguous, order-preserving matches
    chunks = 1
    for (i1, j1), (i2, j2) in zip(pairs, pairs[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    penalty = 0.5 * (chunks / m) ** 3
    return fmean * (1.0 - penalty)


def meteor(predictions: List[str], references: List[str]) -> float:
    scores = [
        _meteor_single(p.lower().split(), r.lower().split())
        for p, r in zip(predictions, references)
    ]
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# ComputeMetrics facade (reference compute_metrics.py:13-116)
# ---------------------------------------------------------------------------


class ComputeMetrics:
    """Decode + normalize + score, exception-tolerant like the reference."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def __call__(
        self,
        generated_ids=None,
        inputs_ids=None,
        prefix_ids=None,
        **kwargs,
    ) -> Dict[str, float]:
        decode = lambda ids: self.tokenizer.batch_decode(ids, skip_special_tokens=True)
        prefixes = decode(prefix_ids)
        generations = [normalize_text(s) for s in decode(generated_ids)]
        references = [
            normalize_text(strip_prefix(ref, prefix))
            for prefix, ref in zip(prefixes, decode(inputs_ids))
        ]
        return self.compute_validation_metrics(generations, [[r] for r in references])

    @staticmethod
    def compute_validation_metrics(
        generations: List[str], references: List[List[str]]
    ) -> Dict[str, float]:
        wer_refs = [r[0] for r in references]
        out: Dict[str, float] = {}
        try:
            out["wer"] = wer(generations, wer_refs)
        except Exception as e:  # noqa: BLE001 — parity: metric errors don't kill eval
            print("Can't compute wer:", e)
            out["wer"] = 0.0
        try:
            out["evaluate_bleu"] = bleu(generations, references) * 100
            r = rouge(generations, wer_refs)
            out["evaluate_rouge1"] = r["rouge1"]
            out["evaluate_rouge2"] = r["rouge2"]
            out["evaluate_rougeL"] = r["rougeL"]
            out["evaluate_rougeLsum"] = r["rougeLsum"]
            out["evaluate_meteor"] = meteor(generations, wer_refs)
            # disclose the env-blocked synonym stage IN the metrics dict
            # (not only the one-shot log warning): 0.0 = exact+stem matching
            # only, scores may trail nltk/evaluate METEOR by synonym-only
            # matches; 1.0 = full WordNet-backed alignment
            _, wn = _meteor_backends()
            out["evaluate_meteor_wordnet_stage"] = float(wn is not None)
        except Exception as e:  # noqa: BLE001
            print("Catch eval exception", e)
        return out
