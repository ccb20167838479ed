"""Continuous-batching greedy decode engine (counterpart of
``aat_tpu/serving/engine.py``).

A fixed pool of ``max_slots`` sequence slots shares one static KV cache.
A request is prefilled straight into its slot's rows of the pool; every
``step()`` advances all active slots by one token (per-row cache write
offsets and RoPE positions). Cache layout per slot: positions
``[0, max_prefill_len)`` hold the padded prefix, the next
``max_new_tokens`` positions the generated tokens.

The JAX engine donates its state to each jitted program; here the same
state tensors are updated in place (cache rows, masks, counters), which is
what the donation bought on the TPU: no second copy of the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from aat_tpu_torch.models import decoders


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_prefill_len: int = 96
    max_new_tokens: int = 64
    eos_token_id: int = 2
    pad_token_id: int = 0
    repetition_penalty: float = 1.0
    cache_dtype: str = "bfloat16"

    @property
    def cache_len(self) -> int:
        return self.max_prefill_len + self.max_new_tokens


@dataclasses.dataclass
class EngineState:
    caches: list                  # [(k, v)] per layer, [S, nkv, cache_len, D]
    cache_mask: torch.Tensor      # [S, cache_len] int32
    lengths: torch.Tensor         # [S] true prefix lengths
    n_gen: torch.Tensor           # [S] tokens generated so far
    active: torch.Tensor          # [S] bool
    pending_logits: torch.Tensor  # [S, V] logits awaiting argmax
    generated: torch.Tensor       # [S, max_new_tokens] int32
    seen: torch.Tensor            # [S, V] repetition-penalty mask


class DecodeEngine:
    """Host-side coordinator; all state lives on ``params``' device."""

    def __init__(self, params: dict, lm_config, config: EngineConfig):
        self.params = params
        self.lm_config = lm_config
        self.config = config
        self.device = params["embed_tokens"]["embedding"].device
        self._slot_free = list(range(config.max_slots))
        self._results: Dict[int, np.ndarray] = {}
        cdtype = torch.bfloat16 if config.cache_dtype == "bfloat16" else torch.float32
        s, v, dev = config.max_slots, lm_config.vocab_size, self.device
        self.state = EngineState(
            caches=decoders.init_kv_caches(lm_config, s, config.cache_len, cdtype, dev),
            cache_mask=torch.zeros((s, config.cache_len), dtype=torch.int32, device=dev),
            lengths=torch.zeros((s,), dtype=torch.int64, device=dev),
            n_gen=torch.zeros((s,), dtype=torch.int64, device=dev),
            active=torch.zeros((s,), dtype=torch.bool, device=dev),
            pending_logits=torch.zeros((s, v), dtype=torch.float32, device=dev),
            generated=torch.full((s, config.max_new_tokens), config.pad_token_id,
                                 dtype=torch.int32, device=dev),
            seen=torch.zeros((s, v), dtype=torch.bool, device=dev),
        )

    @property
    def free_slots(self) -> int:
        return len(self._slot_free)

    def _as_request(self, inputs_embeds, attention_mask):
        embeds = torch.as_tensor(inputs_embeds, device=self.device)
        if embeds.ndim == 3:
            embeds = embeds[0]
        mask = torch.as_tensor(attention_mask, device=self.device).reshape(-1)
        p, p0 = embeds.shape[0], self.config.max_prefill_len
        if p > p0:
            raise ValueError(f"prefix of {p} exceeds max_prefill_len={p0}")
        embeds = torch.nn.functional.pad(embeds, (0, 0, 0, p0 - p))
        mask = torch.nn.functional.pad(mask.to(torch.int32), (0, p0 - p))
        return embeds, mask

    @torch.no_grad()
    def _prefill(self, slots: List[int], embeds: torch.Tensor, mask: torch.Tensor):
        """Prefill ``[K, P0, H]`` prefixes into fresh cache rows and adopt
        them into ``slots``."""
        cfg, st = self.config, self.state
        k, p0 = embeds.shape[0], cfg.max_prefill_len
        row_caches = decoders.init_kv_caches(self.lm_config, k, cfg.cache_len,
                                             st.caches[0][0].dtype, self.device)
        row_mask = torch.zeros((k, cfg.cache_len), dtype=torch.int32, device=self.device)
        row_mask[:, :p0] = mask
        positions = torch.clamp(torch.cumsum(mask, dim=-1) - 1, min=0)
        logits, row_caches = decoders.forward(
            self.params, self.lm_config, inputs_embeds=embeds,
            attention_mask=row_mask, positions=positions,
            kv_caches=row_caches, cache_index=0)
        lengths = mask.sum(-1).to(torch.int64)
        last = logits[torch.arange(k, device=self.device), torch.clamp(lengths - 1, min=0)]
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        for (ck, cv), (rk, rv) in zip(st.caches, row_caches):
            ck[idx] = rk
            cv[idx] = rv
        st.cache_mask[idx] = row_mask
        st.lengths[idx] = lengths
        st.n_gen[idx] = 0
        st.active[idx] = True
        st.pending_logits[idx] = last.float()
        st.generated[idx] = cfg.pad_token_id
        st.seen[idx] = False

    def submit(self, inputs_embeds, attention_mask) -> Optional[int]:
        """Queue one request (``[P, H]`` or ``[1, P, H]`` embeds, ``[P]``
        mask, P <= max_prefill_len). Returns the slot id, or None when the
        pool is full."""
        if not self._slot_free:
            return None
        embeds, mask = self._as_request(inputs_embeds, attention_mask)
        slot = self._slot_free.pop(0)
        self._prefill([slot], embeds[None], mask[None])
        return slot

    def submit_many(self, requests: List[tuple]) -> List[int]:
        """Admit a burst of (embeds, mask) requests with ONE prefill.
        PyTorch runs eagerly, so the batch is the burst itself: the JAX
        engine's static prefill batch (``max_prefill_batch``) and its parked
        rows have no counterpart. Returns the slot ids in request order."""
        if not requests or len(requests) > len(self._slot_free):
            raise ValueError(f"burst of {len(requests)} with "
                             f"{len(self._slot_free)} free slots")
        pairs = [self._as_request(e, m) for e, m in requests]
        slots = [self._slot_free.pop(0) for _ in requests]
        self._prefill(slots, torch.stack([e for e, _ in pairs]),
                      torch.stack([m for _, m in pairs]))
        return slots

    @torch.no_grad()
    def _step(self) -> torch.Tensor:
        """One decode step for every slot; returns the [S] finished mask."""
        cfg, st = self.config, self.state
        p0 = cfg.max_prefill_len
        bidx = torch.arange(cfg.max_slots, device=self.device)
        logits = st.pending_logits
        if cfg.repetition_penalty != 1.0:
            pen = torch.where(logits > 0, logits / cfg.repetition_penalty,
                              logits * cfg.repetition_penalty)
            logits = torch.where(st.seen, pen, logits)
        token = torch.argmax(logits, dim=-1)
        token = torch.where(st.active, token, cfg.pad_token_id)

        gen_idx = torch.clamp(st.n_gen, max=cfg.max_new_tokens - 1)
        st.generated[bidx, gen_idx] = torch.where(
            st.active, token.to(torch.int32), st.generated[bidx, gen_idx])
        st.seen[bidx, token] = st.seen[bidx, token] | st.active
        n_gen = st.n_gen + st.active.to(torch.int64)
        finished = st.active & ((token == cfg.eos_token_id) | (n_gen >= cfg.max_new_tokens))

        # forward the just-selected token for every slot (inactive rows
        # compute into masked cache entries: static batch, no repack)
        write_pos = torch.clamp(p0 + st.n_gen, max=cfg.cache_len - 1)
        st.cache_mask[bidx, write_pos] = torch.maximum(
            st.cache_mask[bidx, write_pos], st.active.to(torch.int32))
        positions = (st.lengths + st.n_gen)[:, None]
        embeds = decoders.embed_tokens(self.params, token)[:, None, :].to(st.caches[0][0].dtype)
        logits_next, _ = decoders.forward(
            self.params, self.lm_config, inputs_embeds=embeds,
            attention_mask=st.cache_mask, positions=positions,
            kv_caches=st.caches, cache_index=write_pos)
        st.pending_logits = logits_next[:, 0, :].float()
        st.n_gen = n_gen
        st.active = st.active & ~finished
        return finished

    def _collect(self, done: np.ndarray) -> List[int]:
        if len(done):
            gen_host = self.state.generated[torch.as_tensor(done, device=self.device)].cpu().numpy()
            for row, slot in enumerate(done):
                self._results[int(slot)] = gen_host[row]
        return [int(d) for d in done]

    def step(self) -> List[int]:
        """Advance every active slot by one token; returns the slots that
        just finished (their ids become available via ``result``)."""
        finished = self._step().cpu().numpy()
        return self._collect(np.nonzero(finished)[0])

    def run_steps(self, n: int) -> List[int]:
        """Advance every active slot by up to ``n`` tokens with no host
        synchronisation in between (the JAX engine's ``lax.scan`` chunk
        becomes a loop); returns the slots that finished in the chunk."""
        prev_active = self.state.active.clone()
        for _ in range(n):
            self._step()
        done = (prev_active & ~self.state.active).cpu().numpy()
        return self._collect(np.nonzero(done)[0])

    def result(self, slot: int) -> np.ndarray:
        """Generated ids for a finished slot (eos included, pad after); the
        slot returns to the free pool."""
        ids = self._results.pop(slot)
        self._slot_free.append(slot)
        return ids

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Run until every active slot finishes; returns {slot: ids}."""
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while bool(self.state.active.any()):
            for slot in self.step():
                out[slot] = self.result(slot)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out


@torch.no_grad()
def encode_speech_request(model, params, waveform_batch: dict):
    """The decode-engine prefix for ONE utterance: segment encoding,
    projection, audio BOS/EOS wrap and prompt embeds. ``waveform_batch`` is
    a segmented batch of size 1; returns (inputs_embeds [P, H],
    attention_mask [P])."""
    seg = waveform_batch["batched_segments"]
    b, s, f = seg.shape
    if b != 1:
        raise ValueError("one request at a time")
    audio_embeds, frame_mask = model.encode_audio(
        params, seg.reshape(b * s, f),
        waveform_batch["segments_waveforms_mask"].reshape(b * s, f),
        waveform_batch["segments_boarders_attention_mask"].reshape(b * s))
    inputs = model.prepare_audio_inputs(
        params, audio_embeds=audio_embeds, frame_mask=frame_mask,
        input_ids=waveform_batch.get("prefix_input_ids"),
        attention_mask=waveform_batch.get("prefix_attention_mask"),
        segments_count=s)
    return inputs["inputs_embeds"][0], inputs["attention_mask"][0]
