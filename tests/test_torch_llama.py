"""Port Llama decoder vs the JAX package at tiny widths: no-cache forward,
KV-cache prefill, and decode with a scalar and a per-row vector
``cache_index``, in f32 and with a bf16 cache."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aat_tpu.models import llama as jllm
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.utils.port import to_tensors

CFG_J = jllm.tiny_test_config()
CFG_T = tllm.tiny_test_config()


def setup(seed=0):
    jparams = jllm.init_llama_params(seed, CFG_J)
    return jparams, to_tensors(jparams)


def test_no_cache_forward_matches_jax():
    jparams, tparams = setup()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG_J.vocab_size, (2, 9))
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    want, _ = jllm.llama_forward(jparams, CFG_J, input_ids=jnp.asarray(ids),
                                 attention_mask=jnp.asarray(mask))
    got, _ = tllm.llama_forward(tparams, CFG_T, input_ids=torch.from_numpy(ids),
                                attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector_index", [False, True])
def test_prefill_and_decode_match_jax(cache_dtype, vector_index):
    jparams, tparams = setup(1)
    rng = np.random.default_rng(1)
    b, p, cache_len = 3, 6, 12
    embeds = rng.normal(0, 0.5, (b, p, CFG_J.hidden_size)).astype(np.float32)
    mask = np.zeros((b, cache_len), np.int32)
    mask[:, :p] = 1
    mask[2, 4:p] = 0
    jdt = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32

    jc = jllm.init_kv_caches(CFG_J, b, cache_len, jdt)
    tc = tllm.init_kv_caches(CFG_T, b, cache_len, tdt)
    want, jc = jllm.llama_forward(jparams, CFG_J, inputs_embeds=jnp.asarray(embeds),
                                  attention_mask=jnp.asarray(mask), kv_caches=jc)
    got, tc = tllm.llama_forward(tparams, CFG_T, inputs_embeds=torch.from_numpy(embeds),
                                 attention_mask=torch.from_numpy(mask), kv_caches=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)

    for step in range(3):
        ids = rng.integers(0, CFG_J.vocab_size, (b,))
        if vector_index:
            idx = np.array([p + step, p + step, p + 2 * step], np.int32)[: b]
            j_idx, t_idx = jnp.asarray(idx), torch.from_numpy(idx)
        else:
            idx = np.full((b,), p + step, np.int32)
            j_idx, t_idx = p + step, p + step
        mask[np.arange(b), idx] = 1
        pos = idx[:, None].astype(np.int32)
        j_emb = jllm.embed_tokens(jparams, jnp.asarray(ids))[:, None, :].astype(jdt)
        t_emb = tllm.embed_tokens(tparams, torch.from_numpy(ids))[:, None, :].to(tdt)
        want, jc = jllm.llama_forward(jparams, CFG_J, inputs_embeds=j_emb,
                                      attention_mask=jnp.asarray(mask),
                                      positions=jnp.asarray(pos), kv_caches=jc,
                                      cache_index=j_idx)
        got, tc = tllm.llama_forward(tparams, CFG_T, inputs_embeds=t_emb,
                                     attention_mask=torch.from_numpy(mask),
                                     positions=torch.from_numpy(pos), kv_caches=tc,
                                     cache_index=t_idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0,
                                   err_msg=f"step {step}")
        for (jk, jv), (tk, tv) in zip(jc, tc):
            np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk, np.float32),
                                       atol=2e-4 if cache_dtype == "float32" else 1e-2)


def test_rope_matches_jax():
    pos = np.array([[0, 1, 5, 77]], np.int32)
    jc, js = jllm.rope_cos_sin(jnp.asarray(pos), 64, 10000.0)
    tc, ts = tllm.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_no_cache_causal_kernel_route_raises(monkeypatch):
    """No cache and T >= the gate: both packages take the causal flash
    route (JAX Pallas in interpret mode, the port's plain version on the
    CPU) and agree; caption slicing with a KV cache still raises."""
    import dataclasses

    import aat_tpu.ops.attention as jatt
    import aat_tpu_torch.ops.attention as tatt

    monkeypatch.setattr(jatt, "MIN_PALLAS_SEQ_LEN", 1)
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    jparams, tparams = setup(2)
    jcfg = dataclasses.replace(CFG_J, attention_impl="pallas")
    tcfg = dataclasses.replace(CFG_T, attention_impl="pallas")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, CFG_J.vocab_size, (2, 11))
    mask = np.ones((2, 11), np.int32)
    mask[1, 7:] = 0
    want, _ = jllm.llama_forward(jparams, jcfg, input_ids=jnp.asarray(ids),
                                 attention_mask=jnp.asarray(mask))
    got, _ = tllm.llama_forward(tparams, tcfg, input_ids=torch.from_numpy(ids),
                                attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    caches = tllm.init_kv_caches(CFG_T, 2, 11)
    with pytest.raises(ValueError, match="caption"):
        tllm.llama_forward(tparams, CFG_T, input_ids=torch.from_numpy(ids), kv_caches=caches,
                           logit_caption_len=4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_packed_caption_logits_match_jax(monkeypatch, impl):
    """``pack_len`` rows (per-utterance positions, block-diagonal attention)
    with caption-sliced logits, through ``AslmModel.forward``."""
    import dataclasses

    import aat_tpu.ops.attention as jatt
    import aat_tpu_torch.ops.attention as tatt
    from aat_tpu.models import aslm as jaslm
    from aat_tpu_torch.models import aslm as taslm

    monkeypatch.setattr(jatt, "MIN_PALLAS_SEQ_LEN", 1)
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    jparams, tparams = setup(3)
    kw = dict(audio_encoder_hidden=16, lm_hidden=CFG_J.hidden_size)
    jm = jaslm.AslmModel(jaslm.AslmConfig(**kw), None,
                         dataclasses.replace(CFG_J, attention_impl=impl))
    tm = taslm.AslmModel(taslm.AslmConfig(**kw), None,
                         dataclasses.replace(CFG_T, attention_impl=impl))
    rng = np.random.default_rng(3)
    b, t, cap = 4, 9, 5
    embeds = rng.normal(0, 0.5, (b, t, CFG_J.hidden_size)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[2, 6:] = 0
    for pack in (1, 2):
        want = jm.forward({"lm_decoder": jparams}, jnp.asarray(embeds), jnp.asarray(mask),
                          pack=pack, caption_len=cap)
        got = tm.forward({"lm_decoder": tparams}, torch.from_numpy(embeds),
                         torch.from_numpy(mask), pack=pack, caption_len=cap)
        assert got.shape == (b, cap - 1, CFG_J.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
