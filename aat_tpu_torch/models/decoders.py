"""The ASLM's LM decoders behind one dispatch, by the type of their config:
the Llama family (:mod:`~aat_tpu_torch.models.llama`: SmolLM, Qwen1.5)
and DeepSeek-V2 (:mod:`~aat_tpu_torch.models.deepseek_v2`). The model,
``models/build``, generation, the serving engine and the trainer call
these, never a decoder module directly. An export's ``config.json`` names a DeepSeek-V2
decoder under ``lm_decoder_type``; without that key it is a Llama one."""

from __future__ import annotations

import dataclasses

from aat_tpu_torch.models import deepseek_v2 as dsv2
from aat_tpu_torch.models import llama as llm

LLAMA, DEEPSEEK_V2 = "llama", "deepseek_v2"


def decoder_type(config) -> str:
    return DEEPSEEK_V2 if isinstance(config, dsv2.DeepseekV2Config) else LLAMA


def config_from_dict(kind: str, fields: dict):
    """The decoder config of an export's ``lm_config`` (lists back to tuples)."""
    cls = dsv2.DeepseekV2Config if kind == DEEPSEEK_V2 else llm.LlamaConfig
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()
                  if k in names})


def init_params(seed, config, device=None) -> dict:
    if decoder_type(config) == DEEPSEEK_V2:
        return dsv2.init_deepseek_v2_params(seed, config, device)
    return llm.init_llama_params(seed, config, device)


embed_tokens = llm.embed_tokens  # both decoders keep their embeddings alike


def forward(params: dict, config, pack_len=None, mesh=None, microbatches: int = 0, **kw):
    """``(logits, kv_caches)`` of :func:`~aat_tpu_torch.models.llama.llama_forward`
    or :func:`~aat_tpu_torch.models.deepseek_v2.deepseek_v2_forward`. The
    DeepSeek-V2 decoder takes no packing and no model-parallel mesh (the
    trainer refuses tp, pp and sp for it)."""
    if decoder_type(config) == DEEPSEEK_V2:
        if pack_len is not None:
            raise ValueError("the DeepSeek-V2 decoder does not pack utterances (lm_pack 1)")
        return dsv2.deepseek_v2_forward(params, config, **kw)
    return llm.llama_forward(params, config, pack_len=pack_len, mesh=mesh,
                             microbatches=microbatches, **kw)


def init_kv_caches(config, batch_size: int, max_len: int, dtype, device=None):
    if decoder_type(config) == DEEPSEEK_V2:
        return dsv2.init_kv_caches(config, batch_size, max_len, dtype, device)
    return llm.init_kv_caches(config, batch_size, max_len, dtype, device)
