"""The port's metrics (``aat_tpu_torch.training.metrics``, a copy of
``aat_tpu/training/metrics.py``): the eight cases of
``tests/test_metrics.py`` on the port, each value also equal to the JAX
package's on the same input, and ``ComputeMetrics`` equal to JAX's on the
same random ids."""

import numpy as np
import pytest

from aat_tpu.training import metrics as J
from aat_tpu_torch.training import metrics as M


def both(name, *args):
    """The port's value of ``name``, after checking it equals JAX's."""
    got, want = getattr(M, name)(*args), getattr(J, name)(*args)
    assert got == want, (name, args, got, want)
    return got


def test_wer_known_values():
    assert both("wer", ["a b c"], ["a b c"]) == 0.0
    assert abs(both("wer", ["a x c"], ["a b c"]) - 1 / 3) < 1e-9
    assert abs(both("wer", ["a x c", "d e"], ["a b c", "d e"]) - 1 / 5) < 1e-9
    assert abs(both("wer", ["a b c d"], ["a b c"]) - 1 / 3) < 1e-9


def test_bleu_perfect_and_zero():
    assert abs(both("bleu", ["the cat sat on the mat"], [["the cat sat on the mat"]]) - 1) < 1e-9
    assert both("bleu", ["x y"], [["a b c"]]) == 0.0


def test_bleu_brevity_penalty():
    full = both("bleu", ["a b c d e f g h"], [["a b c d e f g h"]])
    short = both("bleu", ["a b c d e f"], [["a b c d e f g h"]])
    assert short < full


def test_rouge_known():
    r = both("rouge", ["the cat sat"], ["the cat sat"])
    assert r["rouge1"] == r["rouge2"] == r["rougeL"] == r["rougeLsum"] == 1.0
    r = both("rouge", ["the cat"], ["the dog"])
    assert abs(r["rouge1"] - 0.5) < 1e-9
    assert r["rouge2"] == 0.0
    both("rouge", ["a b\nc d e", "x"], ["a c\nd e b", "x y"])


def test_meteor_perfect_close_to_one():
    s = both("meteor", ["the cat sat on the mat"], ["the cat sat on the mat"])
    assert 0.99 < s <= 1.0
    assert both("meteor", ["x"], ["y"]) == 0.0


def test_normalization_pipeline():
    assert both("normalize_text", " Hello\nWorld  ") == "hello world"
    assert both("strip_prefix", "PREFIX rest of text", "PREFIX ") == "rest of text"


class FakeTokenizer:
    """Ids to single letters (negative ids are skipped)."""

    def batch_decode(self, ids, skip_special_tokens=True):
        return [" ".join(chr(97 + int(t) % 26) for t in row if int(t) >= 0)
                for row in np.asarray(ids)]


def test_compute_metrics_facade():
    cm = M.ComputeMetrics(FakeTokenizer())
    ids = np.array([[0, 1, 2, 3, 4]])
    out = cm(generated_ids=ids, inputs_ids=ids, prefix_ids=np.array([[-1]]))
    assert out["wer"] == 0.0
    assert out["evaluate_bleu"] > 99.0
    assert out["evaluate_rouge1"] == 1.0
    # random ids with prefixes: every metric equal to JAX's, exactly
    rng = np.random.default_rng(0)
    gen = rng.integers(-1, 12, (6, 9))
    refs = rng.integers(0, 12, (6, 11))
    prefs = refs[:, :2].copy()
    kw = dict(generated_ids=gen, inputs_ids=refs, prefix_ids=prefs)
    got, want = cm(**kw), J.ComputeMetrics(FakeTokenizer())(**kw)
    assert got == want and set(got) >= {"wer", "evaluate_bleu", "evaluate_rouge1",
                                        "evaluate_rouge2", "evaluate_rougeL",
                                        "evaluate_rougeLsum", "evaluate_meteor"}


def test_meteor_stem_matching():
    """Porter-stem stage: 'sitting' aligns with 'sits'."""
    pytest.importorskip("nltk")
    M._STEM = None
    J._STEM = None
    s_exact = both("meteor", ["the cat sat"], ["the cat sat"])
    s_stem = both("meteor", ["the cats sitting"], ["the cat sits"])
    assert s_stem > 0.9, s_stem
    assert s_exact > s_stem - 1e-9


def test_meteor_matches_nltk_without_wordnet(monkeypatch):
    """nltk's meteor_score with the WordNet stage neutralized agrees to
    float precision (exact and stem stages, fmean and fragmentation)."""
    pytest.importorskip("nltk")
    import nltk.translate.meteor_score as ms

    class _NoSyn:
        @staticmethod
        def synsets(word):
            return []

    monkeypatch.setattr(M, "_WORDNET", None)
    monkeypatch.setattr(J, "_WORDNET", None)
    cases = [
        ("the quick brown fox jumps", "the fast brown foxes jumped high"),
        ("a b c d", "d c b a"),
        ("running dogs barked loudly", "the running dog barks loud"),
        ("completely different words here", "nothing alike at all whatsoever"),
        ("it is a guide to action", "it is a guide to action which ensures"),
    ]
    for hyp, ref in cases:
        ours = both("meteor", [hyp], [ref])
        theirs = ms.meteor_score([ref.split()], hyp.split(), wordnet=_NoSyn())
        assert abs(ours - theirs) < 1e-9, (hyp, ref, ours, theirs)
