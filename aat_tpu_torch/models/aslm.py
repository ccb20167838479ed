"""ASLM — audio encoder + segment projection + audio BOS/EOS + Llama
decoder (counterpart of ``aat_tpu/models/aslm.py``). ``dropout_seed``
(an int32, or None for eval) selects the encoder's train mode.

Projection types ported: ``linear`` (zero masked frames, crop T to a
multiple of k, ``[N, T/k, k*E]`` → MLP → LM hidden) and ``mean`` (masked
mean → Linear). The ``transformer_encoder`` pooling projection is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.models import llama as llm
from aat_tpu_torch.ops.ragged import masked_mean
from aat_tpu_torch.utils.port import to_tensors


@dataclasses.dataclass(frozen=True)
class AslmConfig:
    projection_type: str = "linear"  # linear | mean
    audio_encoder_embeddings_seq_len: int = 1
    audio_encoder_hidden: int = 1024
    lm_hidden: int = 576
    projection_hidden: int = 4096
    audio_bos_token_id: int = 0
    audio_eos_token_id: int = 1


def init_aslm_numpy(seed: int, config: AslmConfig, std: float = 0.02) -> dict:
    """The JAX package's int-seed adapter draws (linear and mean), as numpy."""
    r = np.random.default_rng(int(seed))
    e, h_lm = config.audio_encoder_hidden, config.lm_hidden

    def normal(*shape):
        return r.normal(0.0, std, shape).astype(np.float32)

    def dense(din, dout):
        return {"kernel": normal(din, dout), "bias": np.zeros((dout,), np.float32)}

    params: dict = {"audio_tokens_embeddings": {"embedding": normal(2, h_lm)}}
    if config.projection_type == "linear":
        k = config.audio_encoder_embeddings_seq_len
        params["projection"] = {"in": dense(e * k, config.projection_hidden),
                                "out": dense(config.projection_hidden, h_lm)}
    elif config.projection_type == "mean":
        params["projection"] = {"out": dense(e, h_lm)}
    else:
        raise ValueError(f"unsupported projection_type: {config.projection_type}")
    return params


def init_aslm_params(seed: int, config: AslmConfig, device=None) -> dict:
    """Random init equal to the JAX package's ``init_aslm_params(seed)``."""
    return to_tensors(init_aslm_numpy(seed, config), device)


def _dense(x, p):
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"]


class AslmModel:
    """Functional ASLM: methods take explicit parameter trees
    ``{"audio_encoder", "adapter", "lm_decoder"}``."""

    def __init__(self, config: AslmConfig, audio_encoder_config: hub.HubertConfig,
                 lm_config: llm.LlamaConfig):
        self.config = config
        self.audio_encoder_config = audio_encoder_config
        self.lm_config = lm_config

    def init_params(self, seed: int, device=None) -> dict:
        """Int-seed init: encoder from ``seed``, adapter from ``seed + 1``,
        decoder from ``seed + 2`` (each equal to the JAX int-seed init of
        its part)."""
        return {
            "audio_encoder": hub.init_hubert_params(seed, self.audio_encoder_config, device),
            "adapter": init_aslm_params(seed + 1, self.config, device),
            "lm_decoder": llm.init_llama_params(seed + 2, self.lm_config, device),
        }

    def encode_audio(self, params: dict, waveforms: torch.Tensor,
                     waveforms_mask: Optional[torch.Tensor] = None,
                     segments_mask: Optional[torch.Tensor] = None,
                     dropout_seed: Optional[int] = None):
        """[N, F] segment waveforms → ([N, T, E] frames, [N, T] frame mask);
        frames of padded segments (``segments_mask`` 0) are masked out."""
        frames, frame_mask = hub.hubert_encode(
            params["audio_encoder"], self.audio_encoder_config, waveforms, waveforms_mask,
            dropout_seed=dropout_seed)
        if frame_mask is None:
            frame_mask = torch.ones(frames.shape[:2], dtype=torch.bool, device=frames.device)
        if segments_mask is not None:
            frame_mask = frame_mask & segments_mask[:, None].bool()
        return frames, frame_mask

    def project_audio_embeddings(self, params: dict, audio_embeds: torch.Tensor,
                                 frame_mask: torch.Tensor):
        """[N, T, E] + [N, T] → ([N, P, H_lm], [N, P] mask)."""
        cfg = self.config
        adapter = params["adapter"]
        n = audio_embeds.shape[0]
        if cfg.projection_type == "linear":
            k = cfg.audio_encoder_embeddings_seq_len
            t = audio_embeds.shape[1]
            cropped_t = t - (t % k)
            reduced_t = cropped_t // k
            x = audio_embeds * frame_mask[..., None].to(audio_embeds.dtype)
            x = x[:, :cropped_t, :].reshape(n, reduced_t, -1)
            y = _dense(F.relu(_dense(x, adapter["projection"]["in"])),
                       adapter["projection"]["out"])
            out_mask = frame_mask[:, :cropped_t].reshape(n, reduced_t, k).any(-1)
            return y, out_mask
        if cfg.projection_type == "mean":
            pooled = masked_mean(audio_embeds, frame_mask)
            y = _dense(pooled[:, None, :], adapter["projection"]["out"])
            return y, frame_mask.any(-1, keepdim=True)
        raise ValueError(f"unsupported projection_type: {cfg.projection_type}")

    def prepare_audio_inputs(self, params: dict, audio_embeds: torch.Tensor,
                             frame_mask: torch.Tensor,
                             inputs_embeds: Optional[torch.Tensor] = None,
                             attention_mask: Optional[torch.Tensor] = None,
                             input_ids: Optional[torch.Tensor] = None,
                             segments_count: Optional[int] = None,
                             dropout_seed: Optional[int] = None) -> dict:
        """Project audio, wrap with audio BOS/EOS embeddings, concat text.
        With ``segments_count``, ``audio_embeds`` is ``[B*S, ...]`` and the
        projected vectors unflatten to ``[B, S*P, H]``. ``dropout_seed`` is
        accepted for the JAX signature: the linear and mean projections have
        no dropout (the transformer_encoder projection, not ported, has)."""
        cfg = self.config
        if input_ids is not None:
            inputs_embeds = self.encode_text(params, input_ids)
        projected, proj_mask = self.project_audio_embeddings(params, audio_embeds, frame_mask)
        if segments_count is not None:
            h, p = projected.shape[-1], projected.shape[1]
            projected = projected.reshape(-1, segments_count * p, h)
            proj_mask = proj_mask.reshape(-1, segments_count * p)

        batch_size = projected.shape[0]
        emb = params["adapter"]["audio_tokens_embeddings"]["embedding"]
        bos = emb[cfg.audio_bos_token_id][None, None, :].expand(batch_size, 1, -1).to(projected.dtype)
        eos = emb[cfg.audio_eos_token_id][None, None, :].expand(batch_size, 1, -1).to(projected.dtype)
        ones = torch.ones((batch_size, 1), dtype=torch.int32, device=projected.device)
        pieces = [bos, projected, eos]
        mask_pieces = [ones, proj_mask.to(torch.int32), ones]
        if inputs_embeds is not None:
            pieces.append(inputs_embeds.to(projected.dtype))
            if attention_mask is None:
                attention_mask = torch.ones(inputs_embeds.shape[:2], dtype=torch.int32,
                                            device=projected.device)
            mask_pieces.append(attention_mask.to(torch.int32))
        return {
            "inputs_embeds": torch.cat(pieces, dim=1),
            "attention_mask": torch.cat(mask_pieces, dim=1),
            "audio_embeds": projected,
            "audio_embeds_attention_mask": proj_mask,
        }

    def encode_text(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return llm.embed_tokens(params["lm_decoder"], input_ids)

    def forward(self, params: dict, inputs_embeds: torch.Tensor,
                attention_mask: torch.Tensor, pack: int = 1,
                caption_len: Optional[int] = None) -> torch.Tensor:
        """LM forward over assembled embeds → f32 logits. ``pack`` > 1 folds
        that many utterance rows into each LM row (block-diagonal attention,
        rotary positions restarting per utterance: the same logits as
        unpacked). ``caption_len``: logits only for the shifted-caption
        window, ``[B, caption_len−1, V]``."""
        out_t = caption_len - 1 if caption_len is not None else None
        if pack > 1:
            b, t, h = inputs_embeds.shape
            if b % pack:
                raise ValueError(f"batch {b} is not a multiple of lm_pack {pack}")
            packed = inputs_embeds.reshape(b // pack, pack * t, h)
            mask = attention_mask.reshape(b // pack, pack * t)
            positions = torch.arange(t, device=inputs_embeds.device).repeat(pack)[None, :]
            logits, _ = llm.llama_forward(
                params["lm_decoder"], self.lm_config, inputs_embeds=packed,
                attention_mask=mask, positions=positions.expand(b // pack, pack * t),
                pack_len=t, logit_caption_len=caption_len)
            return logits.reshape(b, out_t or t, logits.shape[-1])
        logits, _ = llm.llama_forward(
            params["lm_decoder"], self.lm_config, inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, logit_caption_len=caption_len)
        return logits
