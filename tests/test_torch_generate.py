"""Port generation (``aat_tpu_torch.training.generate``) against the JAX
package's ``greedy_generate`` / ``beam_generate`` and HF ``generate`` on a
tiny random ``LlamaForCausalLM`` built from a config (nothing downloaded):
the nine cases of ``tests/test_generate.py``, token for token, plus a
tie-heavy beam case where the order of equal top-k values decides the ids."""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from aat_tpu.training import generate as jgen  # noqa: E402
from aat_tpu.utils.port import port_llama  # noqa: E402
from aat_tpu_torch.models import llama as tllm  # noqa: E402
from aat_tpu_torch.training import generate as tgen  # noqa: E402
from aat_tpu_torch.utils.port import to_tensors  # noqa: E402
from tests.test_llama import build_torch_llama  # noqa: E402

torch.backends.mkldnn.enabled = False


def port_config(jcfg):
    fields = {f.name for f in dataclasses.fields(tllm.LlamaConfig)}
    return tllm.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


@pytest.fixture(scope="module")
def ported():
    hf = build_torch_llama()
    jparams, jcfg = port_llama(hf)
    return hf, (jparams, jcfg), (to_tensors(jparams), port_config(jcfg))


def run_both(ported, embeds, mask, beams=False, **kw):
    """The same config through JAX and the port → (jax ids, port ids)."""
    _, (jp, jcfg), (tp, tcfg) = ported
    jfn, tfn = (jgen.beam_generate, tgen.beam_generate) if beams else (
        jgen.greedy_generate, tgen.greedy_generate)
    want = np.asarray(jfn(jp, jcfg, jnp.asarray(embeds), jnp.asarray(mask),
                          jgen.GenerationConfig(**kw)))
    got = tfn(tp, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask),
              tgen.GenerationConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, want)
    return want, got


def hf_generate(hf, embeds, mask, **kw):
    with torch.no_grad():
        return hf.generate(inputs_embeds=torch.from_numpy(embeds),
                           attention_mask=torch.from_numpy(mask), do_sample=False, **kw).numpy()


def test_greedy_matches_hf(ported):
    rng = np.random.default_rng(0)
    embeds = rng.normal(0, 0.02, (2, 5, 32)).astype(np.float32)
    mask = np.ones((2, 5), dtype=np.int64)
    ref = hf_generate(ported[0], embeds, mask, max_new_tokens=8, num_beams=1,
                      eos_token_id=None, pad_token_id=0)
    _, got = run_both(ported, embeds, mask, max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    np.testing.assert_array_equal(got, ref[:, :8])


def test_greedy_ragged_prompt(ported):
    """Right-padded prompts decode as if unpadded (positions and masks)."""
    rng = np.random.default_rng(1)
    e_short = rng.normal(0, 0.02, (1, 3, 32)).astype(np.float32)
    padded = np.zeros((1, 6, 32), np.float32)
    padded[:, :3] = e_short
    kw = dict(max_new_tokens=6, eos_token_id=-1, pad_token_id=0)
    _, out_padded = run_both(ported, padded, np.array([[1, 1, 1, 0, 0, 0]], np.int64), **kw)
    _, out_exact = run_both(ported, e_short, np.ones((1, 3), np.int64), **kw)
    np.testing.assert_array_equal(out_padded, out_exact)


def test_no_repeat_ngram_bans_loops(ported):
    rng = np.random.default_rng(2)
    embeds = rng.normal(0, 0.02, (1, 4, 32)).astype(np.float32)
    _, out = run_both(ported, embeds, np.ones((1, 4), np.int64), max_new_tokens=24,
                      eos_token_id=-1, pad_token_id=0, no_repeat_ngram_size=3)
    trigrams = set()
    for i in range(len(out[0]) - 2):
        tg = tuple(out[0, i : i + 3])
        assert tg not in trigrams, f"repeated trigram {tg} in {out[0]}"
        trigrams.add(tg)


def test_repetition_penalty_changes_output(ported):
    rng = np.random.default_rng(3)
    embeds = rng.normal(0, 0.02, (1, 4, 32)).astype(np.float32)
    mask = np.ones((1, 4), np.int64)
    kw = dict(max_new_tokens=16, eos_token_id=-1, pad_token_id=0)
    _, base = run_both(ported, embeds, mask, **kw)
    _, pen = run_both(ported, embeds, mask, repetition_penalty=5.0, **kw)
    assert not np.array_equal(base, pen) or len(set(base[0].tolist())) == base.shape[1]


def test_beam_reference_settings_smoke(ported):
    """Beam 3 + repetition 2.5 + no-repeat-4-gram (the reference's eval
    settings) on static shapes."""
    rng = np.random.default_rng(4)
    embeds = rng.normal(0, 0.02, (2, 5, 32)).astype(np.float32)
    _, out = run_both(ported, embeds, np.ones((2, 5), np.int64), beams=True, max_new_tokens=10,
                      num_beams=3, repetition_penalty=2.5, no_repeat_ngram_size=4,
                      eos_token_id=-1, pad_token_id=0)
    assert out.shape == (2, 10)


def test_beam_matches_hf_without_eos(ported):
    rng = np.random.default_rng(6)
    embeds = rng.normal(0, 0.02, (2, 5, 32)).astype(np.float32)
    mask = np.ones((2, 5), dtype=np.int64)
    ref = hf_generate(ported[0], embeds, mask, max_new_tokens=8, num_beams=3,
                      eos_token_id=None, pad_token_id=0, length_penalty=1.0,
                      early_stopping=False)
    _, got = run_both(ported, embeds, mask, beams=True, max_new_tokens=8, num_beams=3,
                      eos_token_id=-1, pad_token_id=0)
    np.testing.assert_array_equal(got, ref[:, :8])


def assert_matches_hf(ours, ref, pad):
    """HF crops to the longest generated length and pad-fills: the overlap
    is equal and ours holds pad after it."""
    width = ref.shape[1]
    np.testing.assert_array_equal(ours[:, :width], ref)
    assert np.all(ours[:, width:] == pad), (ours, ref)


def test_beam_with_eos_matches_hf(ported):
    """Finished candidates ranked < num_beams retire into the K-slot pool;
    the selected sequence equals HF's, eos included, and pad=0 fills with
    eos (HF's ``pad_token_id or eos_token_id``)."""
    rng = np.random.default_rng(8)
    embeds = rng.normal(0, 0.02, (2, 4, 32)).astype(np.float32)
    mask = np.ones((2, 4), dtype=np.int64)
    probe, _ = run_both(ported, embeds, mask, beams=True, max_new_tokens=6, num_beams=3,
                        eos_token_id=-1, pad_token_id=0)
    eos = int(probe[0, 3])
    ref = hf_generate(ported[0], embeds, mask, max_new_tokens=10, num_beams=3, eos_token_id=eos,
                      pad_token_id=0, length_penalty=1.0, early_stopping=False)
    _, got = run_both(ported, embeds, mask, beams=True, max_new_tokens=10, num_beams=3,
                      eos_token_id=eos, pad_token_id=0)
    assert_matches_hf(got, ref, pad=eos)


def test_beam_reference_gen_params_match_hf(ported):
    """The reference's gen_params verbatim: early stopping, pad = forced
    eos = eos, repetition 2.5, no-repeat-4-gram, beam 3."""
    rng = np.random.default_rng(11)
    embeds = rng.normal(0, 0.02, (3, 5, 32)).astype(np.float32)
    mask = np.ones((3, 5), dtype=np.int64)
    probe, _ = run_both(ported, embeds, mask, beams=True, max_new_tokens=8, num_beams=3,
                        repetition_penalty=2.5, no_repeat_ngram_size=4, eos_token_id=-1,
                        pad_token_id=0)
    eos = int(probe[1, 4])
    ref = hf_generate(ported[0], embeds, mask, max_new_tokens=12, early_stopping=True,
                      num_beams=3, repetition_penalty=2.5, remove_invalid_values=True,
                      eos_token_id=eos, pad_token_id=eos, forced_eos_token_id=eos,
                      use_cache=True, no_repeat_ngram_size=4, num_return_sequences=1)
    _, got = run_both(ported, embeds, mask, beams=True, max_new_tokens=12, num_beams=3,
                      repetition_penalty=2.5, no_repeat_ngram_size=4, eos_token_id=eos,
                      pad_token_id=eos, early_stopping=True, forced_eos_token_id=eos)
    assert_matches_hf(got, ref, pad=eos)
    # the trainer's entry point dispatches on num_beams
    _, _, (tp, tcfg) = ported
    cfg = tgen.GenerationConfig(max_new_tokens=12, num_beams=3, repetition_penalty=2.5,
                                no_repeat_ngram_size=4, eos_token_id=eos, pad_token_id=eos,
                                early_stopping=True, forced_eos_token_id=eos)
    np.testing.assert_array_equal(
        tgen.generate(tp, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask), cfg).numpy(),
        got)


def test_eos_terminates_and_pads(ported):
    rng = np.random.default_rng(5)
    embeds = rng.normal(0, 0.02, (1, 4, 32)).astype(np.float32)
    mask = np.ones((1, 4), np.int64)
    base, _ = run_both(ported, embeds, mask, max_new_tokens=12, eos_token_id=-1, pad_token_id=0)
    eos = int(base[0, 2])
    _, out = run_both(ported, embeds, mask, max_new_tokens=12, eos_token_id=eos, pad_token_id=7)
    stop = out[0].tolist().index(eos)
    assert all(t == 7 for t in out[0, stop + 1 :])


def top_k_highest_first(x, k, lowest_first=tgen.top_k_lowest_first):
    """A top-k that breaks ties the other way (the highest index first)."""
    values, idx = lowest_first(x.flip(-1), k)
    return values, x.shape[-1] - 1 - idx


def test_beam_ties_take_the_lowest_index(monkeypatch):
    """Tokens come in groups of four that the model cannot tell apart (the
    LM head's and the embedding's rows 32-127 repeat 0-31), so every step's
    2K = 6 best candidates hold a tied group that the K = 3 running beams
    cut, beams tie with beams, and the NEG_INF beams and pool slots tie as
    well. JAX's top_k puts the lowest index first; the
    port must give its ids, with and without eos and the reference's
    processors, and the other tie order must not."""
    hf = build_torch_llama()
    with torch.no_grad():
        for table in (hf.lm_head.weight, hf.model.embed_tokens.weight):
            table[32:] = table[:32].repeat(3, 1)
    jp, jcfg = port_llama(hf)
    tp, tcfg = to_tensors(jp), port_config(jcfg)
    rng = np.random.default_rng(12)
    embeds = rng.normal(0, 0.02, (3, 5, 32)).astype(np.float32)
    mask = np.ones((3, 5), np.int64)
    mask[2, 3:] = 0
    logits, _ = tllm.llama_forward(tp, tcfg, inputs_embeds=torch.from_numpy(embeds))
    for g in (1, 2, 3):  # the ties are exact
        assert torch.equal(logits[..., 32 * g : 32 * g + 32], logits[..., :32])
    both = (hf, (jp, jcfg), (tp, tcfg))
    probe, _ = run_both(both, embeds, mask, beams=True, max_new_tokens=6, num_beams=3,
                        eos_token_id=-1, pad_token_id=0)
    eos = int(probe[0, 2])
    cases = [dict(eos_token_id=eos, pad_token_id=0),
             dict(repetition_penalty=2.5, no_repeat_ngram_size=2, eos_token_id=eos,
                  pad_token_id=eos, early_stopping=True, forced_eos_token_id=eos)]
    want = [run_both(both, embeds, mask, beams=True, max_new_tokens=10, num_beams=3, **kw)[0]
            for kw in cases]
    # the ties decide: the other tie order gives other ids
    monkeypatch.setattr(tgen, "top_k_lowest_first", top_k_highest_first)
    for w, kw in zip(want, cases):
        other = tgen.beam_generate(tp, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask),
                                   tgen.GenerationConfig(max_new_tokens=10, num_beams=3, **kw))
        assert not np.array_equal(other.numpy(), w)
    monkeypatch.undo()
    # the port's own top-k on an all-equal row: indices in order
    values, idx = tgen.top_k_lowest_first(torch.full((2, 9), tgen.NEG_INF), 4)
    assert idx.tolist() == [[0, 1, 2, 3]] * 2 and (values == tgen.NEG_INF).all()
