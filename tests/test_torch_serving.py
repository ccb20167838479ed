"""The port's speech-serving path end to end vs the JAX package's at tiny
widths: raw waveform → segment_raw_batch → encode_speech_request →
DecodeEngine, in adaptive and whole-utterance modes, with f32 and bf16
caches; token ids must be identical. Also submit_many == sequential
admission, and the port's serve loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aat_tpu.data import ondevice as jdata
from aat_tpu.serving import engine as jeng
from aat_tpu_torch.data import ondevice as tdata
from aat_tpu_torch.serving import engine as teng
from aat_tpu_torch.serving import serve as tserve
from aat_tpu_torch.utils.port import from_jax_params
from tests.conftest import make_speechlike_waveform
from tests.test_torch_port import jax_int_seed_params, tiny_configs

MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    jmodel, tmodel = tiny_configs()
    jparams = jax_int_seed_params(jmodel, seed=0)
    # a wider decoder init than std 0.02 makes the greedy argmax decisive,
    # so token equality tests the computation rather than near-ties
    from aat_tpu.models import llama as jllm

    jparams["lm_decoder"] = jllm.init_llama_params(2, jmodel.lm_config, std=0.3)
    return jmodel, jparams, tmodel, from_jax_params(jparams)


def waves(seed, durations):
    return [make_speechlike_waveform(np.random.default_rng(seed + i), d).astype(np.float32)
            for i, d in enumerate(durations)]


def seg_kwargs(mode, pad_to):
    if mode == "whole":
        return dict(segmentation="uniform", max_segments=1, max_segment_frames=pad_to)
    return dict(segmentation="adaptive", max_segments=8, max_segment_frames=4000)


def prefixes(mode, ws, jmodel, jparams, tmodel, tparams):
    pad_to = tserve.padded_length(ws)
    out_j, out_t = [], []
    for w in ws:
        x = np.zeros((1, pad_to), np.float32)
        x[0, : w.size] = w
        n = np.array([w.size], np.int32)
        jb = jdata.segment_raw_batch({"raw_waveforms": jnp.asarray(x), "raw_lengths": jnp.asarray(n)},
                                     sampling_rate=16000, **seg_kwargs(mode, pad_to))
        tb = tdata.segment_raw_batch({"raw_waveforms": torch.from_numpy(x),
                                      "raw_lengths": torch.from_numpy(n)},
                                     sampling_rate=16000, **seg_kwargs(mode, pad_to))
        out_j.append(jeng.encode_speech_request(jmodel, jparams, jb))
        out_t.append(teng.encode_speech_request(tmodel, tparams, tb))
    return out_j, out_t


def decode(engine, pfx):
    slots = [engine.submit(e, m) for e, m in pfx]
    got = engine.drain()
    return [np.asarray(got[s]) for s in slots]


@pytest.mark.parametrize("mode,durations", [("adaptive", [0.8, 1.3]), ("whole", [0.5, 0.9])])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_speech_serving_tokens_equal_jax(models, mode, durations, cache_dtype):
    jmodel, jparams, tmodel, tparams = models
    pj, pt = prefixes(mode, waves(11, durations), jmodel, jparams, tmodel, tparams)
    for (je, jm), (te, tm) in zip(pj, pt):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=2e-4, rtol=0)
    p0 = int(pj[0][0].shape[0])
    cfg_kw = dict(max_slots=2, max_prefill_len=p0, max_new_tokens=MAX_NEW,
                  eos_token_id=2, cache_dtype=cache_dtype)
    want = decode(jeng.DecodeEngine(jparams["lm_decoder"], jmodel.lm_config,
                                    jeng.EngineConfig(**cfg_kw)), pj)
    got = decode(teng.DecodeEngine(tparams["lm_decoder"], tmodel.lm_config,
                                   teng.EngineConfig(**cfg_kw)), pt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_submit_many_equals_sequential(models):
    _, _, tmodel, tparams = models
    rng = np.random.default_rng(3)
    p0, h = 10, tmodel.lm_config.hidden_size
    reqs = []
    for n in (4, 10, 7):
        e = rng.normal(0, 0.5, (p0, h)).astype(np.float32)
        m = np.zeros((p0,), np.int32)
        m[:n] = 1
        e[n:] = 0.0
        reqs.append((torch.from_numpy(e), torch.from_numpy(m)))

    def engine():
        return teng.DecodeEngine(tparams["lm_decoder"], tmodel.lm_config, teng.EngineConfig(
            max_slots=4, max_prefill_len=p0, max_new_tokens=MAX_NEW, cache_dtype="float32"))

    want = decode(engine(), reqs)
    burst = engine()
    s0 = burst.submit(*reqs[0])
    got = {}
    for _ in range(3):  # a resident decodes while the burst joins
        got.update({s: burst.result(s) for s in burst.step()})
    slots = burst.submit_many(reqs[1:])
    got.update(burst.drain())
    assert slots == [1, 2]
    for s, w in zip([s0] + slots, want):
        np.testing.assert_array_equal(got[s], w)


@pytest.mark.parametrize("penalty", [1.0, 2.5])
def test_engine_matches_jax_engine_with_repetition_penalty(models, penalty):
    jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(9)
    p0, h = 8, tmodel.lm_config.hidden_size
    embeds = rng.normal(0, 0.5, (3, p0, h)).astype(np.float32)
    masks = np.ones((3, p0), np.int32)
    masks[1, 5:] = 0
    cfg_kw = dict(max_slots=3, max_prefill_len=p0, max_new_tokens=MAX_NEW,
                  eos_token_id=-1, repetition_penalty=penalty, cache_dtype="float32")
    want = decode(jeng.DecodeEngine(jparams["lm_decoder"], jmodel.lm_config,
                                    jeng.EngineConfig(**cfg_kw)),
                  [(jnp.asarray(e), jnp.asarray(m)) for e, m in zip(embeds, masks)])
    got = decode(teng.DecodeEngine(tparams["lm_decoder"], tmodel.lm_config,
                                   teng.EngineConfig(**cfg_kw)),
                 [(torch.from_numpy(e), torch.from_numpy(m)) for e, m in zip(embeds, masks)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serve_loop_reuses_slots(models):
    _, _, tmodel, tparams = models
    ws = waves(21, [0.6, 0.9, 0.4])
    cfg = tserve.ServeConfig(max_slots=2, max_new_tokens=MAX_NEW, max_segments=8, chunk=3)
    out = tserve.serve(tmodel, tparams, ws, cfg)
    assert len(out) == 3
    # each request decodes alone to the same ids (slot reuse is invisible)
    for i, w in enumerate(ws):
        solo = tserve.serve(tmodel, tparams, [w] + ws[:i] + ws[i + 1:], cfg)[0]
        np.testing.assert_array_equal(out[i], solo)
    for ids in out:
        assert ids.shape == (MAX_NEW,) and (ids < tmodel.lm_config.vocab_size).all()
