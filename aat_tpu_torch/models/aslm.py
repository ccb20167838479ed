"""ASLM — audio encoder + segment projection + audio BOS/EOS + Llama
decoder (counterpart of ``aat_tpu/models/aslm.py``). ``dropout_seed``
(an int32, or None for eval) selects the encoder's and the projection's
train mode.

The audio encoder is HuBERT / wav2vec2 on segment waveforms
(:meth:`AslmModel.encode_audio`) or EfficientNet-b0 on segment melspecs
(:meth:`AslmModel.encode_audio_melspec`, ``audio_encoder_type=
"efficient_net"``). Projection types:

- ``linear``: zero masked frames, crop T to a multiple of k, ``[N, T/k,
  k*E]`` → MLP → LM hidden;
- ``mean``: masked mean → Linear;
- ``transformer_encoder``: a learned CLS embedding prepended, a pre-LN
  transformer (torch ``nn.TransformerEncoderLayer`` semantics: ReLU
  feed-forward, key-padding mask, train-mode dropout at four sites a
  layer) and ``l_out`` on the CLS position → ``[N, 1, H_lm]``
  (:func:`pooling_forward`). Its dropout seeds derive from the
  projection's seed with :func:`~aat_tpu_torch.ops.dropout.fold_seed`
  (``(layer, site)``), where JAX splits a key.

``AslmModel.mesh`` is the trainer's mesh (:mod:`aat_tpu_torch.parallel`),
or None: the model passes it to the encoder and the LM (their tensor-,
sequence- and pipeline-parallel routes, the last in
``AslmModel.pp_microbatches``; EfficientNet's global-batch statistics), and
keys the projection's masks on the rows' global positions
(:class:`~aat_tpu_torch.ops.dropout.ElementShard`), so data parallelism
draws one device's masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from aat_tpu_torch.models import decoders
from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.ops.dropout import dropout, fold_seed
from aat_tpu_torch.ops.ragged import masked_mean
from aat_tpu_torch.utils.port import to_tensors


@dataclasses.dataclass(frozen=True)
class PoolingConfig:
    """The ``transformer_encoder`` projection's dims (JAX ``PoolingConfig``)."""

    hidden_dim: int = 4096
    num_heads: int = 32
    num_layers: int = 4
    ffn_dim: int = 2048  # torch TransformerEncoderLayer default
    max_positions: int = 64


@dataclasses.dataclass(frozen=True)
class AslmConfig:
    projection_type: str = "linear"  # linear | transformer_encoder | mean
    audio_encoder_embeddings_seq_len: int = 1
    audio_encoder_hidden: int = 1024
    lm_hidden: int = 576
    projection_hidden: int = 4096
    pooling: PoolingConfig = PoolingConfig()
    audio_bos_token_id: int = 0
    audio_eos_token_id: int = 1
    dropout: float = 0.1  # the transformer_encoder projection's train-mode rate


def init_aslm_numpy(seed, config: AslmConfig, std: float = 0.02) -> dict:
    """The JAX package's adapter draws, as numpy, in its order: ``seed``
    is an int or a JAX PRNG key's data words
    (:func:`~aat_tpu_torch.models.hubert.np_rng_from`)."""
    r = hub.np_rng_from(seed)
    e, h_lm = config.audio_encoder_hidden, config.lm_hidden

    def normal(*shape):
        return r.normal(0.0, std, shape).astype(np.float32)

    def dense(din, dout):
        return {"kernel": normal(din, dout), "bias": np.zeros((dout,), np.float32)}

    def layernorm(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    params: dict = {"audio_tokens_embeddings": {"embedding": normal(2, h_lm)}}
    if config.projection_type == "linear":
        k = config.audio_encoder_embeddings_seq_len
        params["projection"] = {"in": dense(e * k, config.projection_hidden),
                                "out": dense(config.projection_hidden, h_lm)}
    elif config.projection_type == "mean":
        params["projection"] = {"out": dense(e, h_lm)}
    elif config.projection_type == "transformer_encoder":
        p = config.pooling
        params["cls_token"] = {"embedding": normal(1, e)}
        pooling = {
            "l_in": dense(e, p.hidden_dim),
            "positional_embeddings": {"embedding": normal(p.max_positions, p.hidden_dim)},
            "l_out": dense(p.hidden_dim, h_lm),
            "layers": [],
        }
        for _ in range(p.num_layers):
            pooling["layers"].append({
                "attention": {"in_proj": dense(p.hidden_dim, 3 * p.hidden_dim),
                              "out_proj": dense(p.hidden_dim, p.hidden_dim)},
                "norm1": layernorm(p.hidden_dim),
                "norm2": layernorm(p.hidden_dim),
                "linear1": dense(p.hidden_dim, p.ffn_dim),
                "linear2": dense(p.ffn_dim, p.hidden_dim),
            })
        params["pooling"] = pooling
    else:
        raise ValueError(f"unsupported projection_type: {config.projection_type}")
    return params


def init_aslm_params(seed, config: AslmConfig, device=None) -> dict:
    """Random init equal to the JAX package's ``init_aslm_params`` of the
    same int seed or PRNG key."""
    return to_tensors(init_aslm_numpy(seed, config), device)


def _dense(x, p):
    """``x @ kernel`` at ``x``'s dtype, then the bias (JAX adds it after the
    cast, so a bf16 activation and an f32 bias promote alike)."""
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"]


# ---------------------------------------------------------------------------
# The transformer_encoder projection (torch nn.TransformerEncoder, pre-LN)
# ---------------------------------------------------------------------------


def _pooling_mha(p, x, key_padding, num_heads: int, seed: Optional[int] = None,
                 rate: float = 0.0, shard=None):
    """torch ``nn.MultiheadAttention`` with packed q/k/v, batch first: the
    scores and P·V with float32 accumulation, the key-padding bias
    ``finfo(float32).min``, softmax in float32, the probabilities cast to
    the compute dtype before their dropout (``seed``) and P·V."""
    b, t, d = x.shape
    hd = d // num_heads
    q, k, v = _dense(x, p["in_proj"]).split(d, dim=-1)

    def heads(z):
        return z.reshape(b, t, num_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    bias = torch.where(key_padding[:, None, None, :], torch.finfo(torch.float32).min, 0.0)
    probs = torch.softmax(scores + bias, dim=-1).to(x.dtype)
    probs = dropout(seed, probs, rate, shard)
    ctx = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return _dense(ctx.transpose(1, 2).reshape(b, t, d), p["out_proj"])


def pooling_forward(params: dict, config: PoolingConfig, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, dropout_seed: Optional[int] = None,
                    dropout_rate: float = 0.0, shard=None) -> torch.Tensor:
    """``l_in`` → + positions → pre-LN transformer layers with the
    key-padding mask → ``l_out`` on the CLS position: ``[N, T, E]`` →
    ``[N, 1, out]``. ``dropout_seed`` selects train mode: the attention
    probabilities, both residual branches and the feed-forward activation,
    each site seeded ``fold_seed(dropout_seed, layer, site)``; ``shard``
    places the rows in the global batch."""
    h = _dense(inputs_embeds, params["l_in"])
    t = h.shape[1]
    max_positions = params["positional_embeddings"]["embedding"].shape[0]
    if t > max_positions:
        raise AssertionError(
            f"pooling input has {t} positions (CLS + encoder frames) but the "
            f"positional table holds {max_positions}; set "
            f"PoolingConfig.max_positions >= encoder frames per segment + 1 "
            f"(reference contract, modeling_aslm.py:110-112)")
    h = h + params["positional_embeddings"]["embedding"][:t, :]
    key_padding = attention_mask == 0
    for idx, layer in enumerate(params["layers"]):
        s_attn = s_res1 = s_ff = s_res2 = None
        if dropout_seed is not None:
            s_attn, s_res1, s_ff, s_res2 = (fold_seed(dropout_seed, idx, site)
                                            for site in range(4))
        attn_in = hub._layer_norm(h, layer["norm1"], 1e-5)
        attn_out = _pooling_mha(layer["attention"], attn_in, key_padding, config.num_heads,
                                s_attn, dropout_rate, shard)
        h = h + dropout(s_res1, attn_out, dropout_rate, shard)  # torch .dropout1
        y = F.relu(_dense(hub._layer_norm(h, layer["norm2"], 1e-5), layer["linear1"]))
        y = _dense(dropout(s_ff, y, dropout_rate, shard), layer["linear2"])
        h = h + dropout(s_res2, y, dropout_rate, shard)  # torch .dropout2
    return _dense(h[:, 0:1, :], params["l_out"])


class AslmModel:
    """Functional ASLM: methods take explicit parameter trees
    ``{"audio_encoder", "adapter", "lm_decoder"}``. ``audio_encoder_config``
    is a ``HubertConfig``, or an ``EfficientNetConfig`` with
    ``audio_encoder_type="efficient_net"``."""

    def __init__(self, config: AslmConfig, audio_encoder_config, lm_config,
                 audio_encoder_type: str = "hubert"):
        self.config = config
        self.audio_encoder_config = audio_encoder_config
        self.lm_config = lm_config
        self.audio_encoder_type = audio_encoder_type
        self.mesh = None  # the trainer's parallel.mesh.Mesh, which it sets and clears
        self.pp_microbatches = 0  # the pipeline's microbatch count (0: 2·pp), the trainer's

    def init_params(self, seed: int, device=None) -> dict:
        """Int-seed init: encoder from ``seed``, adapter from ``seed + 1``,
        decoder from ``seed + 2`` (each equal to the JAX int-seed init of
        its part; EfficientNet's is ``init_efficientnet_params(seed)``)."""
        if self.audio_encoder_type == "efficient_net":
            from aat_tpu_torch.models.efficientnet import init_efficientnet_params

            encoder = init_efficientnet_params(seed, device)
        else:
            encoder = hub.init_hubert_params(seed, self.audio_encoder_config, device)
        return {
            "audio_encoder": encoder,
            "adapter": init_aslm_params(seed + 1, self.config, device),
            "lm_decoder": decoders.init_params(seed + 2, self.lm_config, device),
        }

    def encode_audio(self, params: dict, waveforms: torch.Tensor,
                     waveforms_mask: Optional[torch.Tensor] = None,
                     segments_mask: Optional[torch.Tensor] = None,
                     dropout_seed: Optional[int] = None):
        """[N, F] segment waveforms → ([N, T, E] frames, [N, T] frame mask);
        frames of padded segments (``segments_mask`` 0) are masked out."""
        frames, frame_mask = hub.hubert_encode(
            params["audio_encoder"], self.audio_encoder_config, waveforms, waveforms_mask,
            dropout_seed=dropout_seed, mesh=self.mesh, microbatches=self.pp_microbatches)
        if frame_mask is None:
            frame_mask = torch.ones(frames.shape[:2], dtype=torch.bool, device=frames.device)
        if segments_mask is not None:
            frame_mask = frame_mask & segments_mask[:, None].bool()
        return frames, frame_mask

    def encode_audio_melspec(self, params: dict, melspecs: torch.Tensor,
                             segments_mask: Optional[torch.Tensor] = None,
                             train: bool = False):
        """EfficientNet: per-segment melspecs ``[N, n_mels, T]`` (or ``[N, 1,
        n_mels, T]``) → ``([N, 1, 1280] frames, [N, 1] mask)``, padded
        segments masked out. ``train=True`` normalizes with the batch's BN
        statistics and also returns them (for
        :func:`~aat_tpu_torch.models.efficientnet.apply_bn_updates`)."""
        from aat_tpu_torch.models.efficientnet import EfficientNetAudioEncoderAdapter

        adapter = EfficientNetAudioEncoderAdapter(self.audio_encoder_config)
        if train:
            frames, bn_stats = adapter(params["audio_encoder"], melspecs, train=True,
                                       mesh=self.mesh)
        else:
            frames = adapter(params["audio_encoder"], melspecs)
        frame_mask = torch.ones(frames.shape[:2], dtype=torch.bool, device=frames.device)
        if segments_mask is not None:
            frame_mask = frame_mask & segments_mask[:, None].bool()
        if train:
            return frames, frame_mask, bn_stats
        return frames, frame_mask

    def project_audio_embeddings(self, params: dict, audio_embeds: torch.Tensor,
                                 frame_mask: torch.Tensor, dropout_seed: Optional[int] = None):
        """[N, T, E] + [N, T] → ([N, P, H_lm], [N, P] mask). ``dropout_seed``
        selects the transformer_encoder projection's train mode (the other
        two have no dropout)."""
        cfg = self.config
        adapter = params["adapter"]
        n = audio_embeds.shape[0]
        if cfg.projection_type == "transformer_encoder":
            cls = adapter["cls_token"]["embedding"][0][None, None, :].expand(
                n, 1, audio_embeds.shape[-1]).to(audio_embeds.dtype)
            with_cls = torch.cat([cls, audio_embeds], dim=1)
            mask_with_cls = torch.cat([torch.ones((n, 1), dtype=frame_mask.dtype,
                                                  device=frame_mask.device), frame_mask], dim=1)
            shard = self.mesh.element_shard() if self.mesh is not None else None
            projected = pooling_forward(adapter["pooling"], cfg.pooling, with_cls, mask_with_cls,
                                        dropout_seed=dropout_seed, dropout_rate=cfg.dropout,
                                        shard=shard)
            return projected, frame_mask.any(-1, keepdim=True)
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
        projected vectors unflatten to ``[B, S*P, H]``. ``dropout_seed``
        goes to :meth:`project_audio_embeddings`."""
        cfg = self.config
        if input_ids is not None:
            inputs_embeds = self.encode_text(params, input_ids)
        projected, proj_mask = self.project_audio_embeddings(params, audio_embeds, frame_mask,
                                                             dropout_seed)
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
        return decoders.embed_tokens(params["lm_decoder"], input_ids)

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
            logits, _ = decoders.forward(
                params["lm_decoder"], self.lm_config, inputs_embeds=packed,
                attention_mask=mask, positions=positions.expand(b // pack, pack * t),
                pack_len=t, logit_caption_len=caption_len, mesh=self.mesh,
                microbatches=self.pp_microbatches)
            return logits.reshape(b, out_t or t, logits.shape[-1])
        logits, _ = decoders.forward(
            params["lm_decoder"], self.lm_config, inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, logit_caption_len=caption_len, mesh=self.mesh,
            microbatches=self.pp_microbatches)
        return logits
