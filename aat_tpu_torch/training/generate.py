"""Autoregressive generation for the ASLM eval path (counterpart of
``aat_tpu/training/generate.py``): greedy decoding and beam search from
``inputs_embeds`` (audio prefix + text prefix), with the reference's eval
settings available (beam 3, repetition penalty 2.5, no-repeat-4-gram,
early stopping, pad = forced eos = eos).

Both run on the decoder's KV-cache route (``models/decoders.forward``:
Llama or DeepSeek-V2), with the cache
on the embeds' device and dtype, as plain Python loops over the decode
steps. Per-row ragged prompt lengths are handled by RoPE positions and
attention masking, as in JAX.

Every top-k here puts the lowest index first among equal values, as
``jax.lax.top_k`` does: beam search ties routinely (the ``NEG_INF`` beams
and pool slots, and their sums), and ``torch.topk`` gives no such order.

The repetition penalty and the n-gram ban consider the *generated* tokens
only (the prompt is embeds, so it contributes no ids).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from aat_tpu_torch.models import decoders

NEG_INF = -1e9  # the f32 sentinel of unused beams and pool slots (exact in f32)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    num_beams: int = 1
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    eos_token_id: int = 2
    pad_token_id: int = 0
    length_penalty: float = 1.0
    # HF flags the reference generates with: early_stopping=True freezes a
    # batch's finished pool once full; forced_eos_token_id forces eos as the
    # final generated token.
    early_stopping: bool = False
    forced_eos_token_id: Optional[int] = None


def top_k_lowest_first(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row,
    sorted descending, the lowest index first among equal values (the
    ``jax.lax.top_k`` order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _apply_repetition_penalty(logits, seen, penalty: float):
    """CTRL-style: for tokens already generated (``seen`` [B, V] bool),
    divide positive scores by ``penalty``, multiply negative ones."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _apply_no_repeat_ngram(logits, generated, step: int, n: int):
    """Ban (``-inf``, as HF's processor) each token x for which the last
    n-1 generated tokens followed by x equal a window ``generated[i:i+n]``
    with i + n <= ``step``. ``generated`` is [B, L], unfilled from ``step``."""
    count = step - n + 1  # windows that lie wholly before `step`
    if n <= 0 or count <= 0:
        return logits
    completions = generated[:, n - 1 : n - 1 + count]  # [B, count]
    if n == 1:
        match = torch.ones_like(completions, dtype=torch.bool)
    else:
        prefix = generated[:, step - (n - 1) : step]  # [B, n-1]
        windows = torch.stack([generated[:, j : j + count] for j in range(n - 1)], dim=-1)
        match = (windows == prefix[:, None, :]).all(-1)
    # an OR over repeated completions: integer adds, then > 0
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, completions, match.to(torch.int32))
    return torch.where(hits > 0, torch.full_like(logits, float("-inf")), logits)


def _process_logits(logits, generated, seen, step: int, config: GenerationConfig):
    logits = _apply_repetition_penalty(logits, seen, config.repetition_penalty)
    return _apply_no_repeat_ngram(logits, generated, step, config.no_repeat_ngram_size)


def _prefill(params, lm_config, inputs_embeds, attention_mask, cache_len):
    """→ (last-position logits [B, V], caches, cache mask [B, cache_len],
    prompt lengths [B])."""
    b, t0, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    caches = decoders.init_kv_caches(lm_config, b, cache_len, inputs_embeds.dtype, dev)
    attention_mask = attention_mask.to(device=dev, dtype=torch.int32)
    cache_mask = torch.zeros((b, cache_len), dtype=torch.int32, device=dev)
    cache_mask[:, :t0] = attention_mask
    positions = torch.clamp_min(torch.cumsum(attention_mask, dim=-1) - 1, 0)
    logits, caches = decoders.forward(params, lm_config, inputs_embeds=inputs_embeds,
                                      attention_mask=cache_mask, positions=positions,
                                      kv_caches=caches, cache_index=0)
    lengths = attention_mask.sum(-1)
    last_logits = logits[torch.arange(b, device=dev), lengths - 1]
    return last_logits, caches, cache_mask, lengths


def _decode_step(params, lm_config, token, caches, cache_mask, positions, slot, dtype):
    """Feed one token per row at cache slot ``slot`` → next logits [B, V]."""
    cache_mask[:, slot] = 1
    embeds = decoders.embed_tokens(params, token)[:, None, :].to(dtype)
    logits, caches = decoders.forward(params, lm_config, inputs_embeds=embeds,
                                      attention_mask=cache_mask, positions=positions[:, None],
                                      kv_caches=caches, cache_index=slot)
    return logits[:, 0, :], caches


@torch.no_grad()
def greedy_generate(params: dict, lm_config, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """Greedy decode → [B, max_new_tokens] ids (pad after eos)."""
    b, t0, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    max_new = config.max_new_tokens
    last_logits, caches, cache_mask, lengths = _prefill(
        params, lm_config, inputs_embeds, attention_mask, t0 + max_new)
    rows = torch.arange(b, device=dev)
    generated = torch.full((b, max_new), config.pad_token_id, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    seen = torch.zeros((b, last_logits.shape[-1]), dtype=torch.bool, device=dev)
    for step in range(max_new):
        logits = _process_logits(last_logits, generated, seen, step, config)
        token = torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
        token = torch.where(finished, torch.full_like(token, config.pad_token_id), token)
        generated[:, step] = token
        seen[rows, token] = True
        finished = finished | (token == config.eos_token_id)
        if step + 1 < max_new:
            last_logits, caches = _decode_step(params, lm_config, token, caches, cache_mask,
                                               lengths + step, t0 + step, inputs_embeds.dtype)
    return generated


@torch.no_grad()
def beam_generate(params: dict, lm_config, inputs_embeds: torch.Tensor,
                  attention_mask: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """Beam search → [B, max_new_tokens] ids of the best finished beam.

    transformers' vectorized ``_beam_search``, step for step (JAX
    ``beam_generate``):

    - processors apply to f32 log-softmax scores, not raw logits;
    - each step takes the top 2K accumulated candidates; those that hit a
      stopping criterion (eos, or the last step) AND rank < K retire into
      a K-slot finished pool scored ``cum_logprob / len**length_penalty``
      (the length counts the eos); the best K that did not finish run on;
    - a batch's pool stops taking hypotheses once it is full
      (``early_stopping``) or once the best running beam provably cannot
      beat its worst entry (the sticky bit);
    - the output holds the eos, then the fill: pad, or eos where pad is 0
      (HF's ``pad_token_id or eos_token_id``).
    """
    b, t0, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    k = config.num_beams
    max_new = config.max_new_tokens
    lp = config.length_penalty
    last_logits, caches, cache_mask, lengths = _prefill(
        params, lm_config, inputs_embeds, attention_mask, t0 + max_new)
    last_logits = last_logits.repeat_interleave(k, dim=0)  # [B*K]: beams of a row adjacent
    caches = [(c[0].repeat_interleave(k, dim=0), c[1].repeat_interleave(k, dim=0))
              for c in caches]
    cache_mask = cache_mask.repeat_interleave(k, dim=0)
    lengths_k = lengths.repeat_interleave(k, dim=0)

    bk = b * k
    fill = config.pad_token_id if config.pad_token_id != 0 else (
        config.eos_token_id if config.eos_token_id >= 0 else -1)
    f32 = dict(dtype=torch.float32, device=dev)
    generated = torch.full((bk, max_new), fill, dtype=torch.long, device=dev)
    # only beam 0 is alive at first
    beam_scores = torch.full((b, k), NEG_INF, **f32)
    beam_scores[:, 0] = 0.0
    pool_seqs = torch.full((b, k, max_new), fill, dtype=torch.long, device=dev)
    pool_scores = torch.full((b, k), NEG_INF, **f32)
    pool_finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    unsat = torch.ones((b,), dtype=torch.bool, device=dev)  # the sticky bit
    seen = torch.zeros((bk, last_logits.shape[-1]), dtype=torch.bool, device=dev)
    batch_idx = torch.arange(b, device=dev)
    first_k = torch.arange(2 * k, device=dev) < k
    zero, neg = torch.zeros((), **f32), torch.full((), NEG_INF, **f32)

    for step in range(max_new):
        logprobs = torch.log_softmax(last_logits.float(), dim=-1)
        logprobs = _process_logits(logprobs, generated, seen, step, config)
        if config.forced_eos_token_id is not None and step == max_new - 1:
            logprobs = torch.full_like(logprobs, float("-inf"))
            logprobs[:, config.forced_eos_token_id] = 0.0
        v = logprobs.shape[-1]
        cand = (beam_scores.reshape(bk)[:, None] + logprobs).reshape(b, k * v)
        top_scores, top_idx = top_k_lowest_first(cand, 2 * k)
        src_beam = top_idx // v
        token = top_idx % v
        hits = token == config.eos_token_id
        if step + 1 >= max_new:
            hits = torch.ones_like(hits)
        parent = generated.reshape(b, k, max_new)[batch_idx[:, None], src_beam]  # [B, 2K, L]
        parent[:, :, step] = token

        # the finished pool (HF _update_finished_beams)
        did_finish = hits & first_k[None, :]
        steps = torch.full((), step + 1, **f32)
        norm = top_scores / steps ** lp
        pool_closed = pool_finished.all(1) & bool(config.early_stopping)
        merge_scores = (norm + torch.where(did_finish, zero, neg)
                        + torch.where(pool_closed[:, None], neg, zero)
                        + torch.where(unsat[:, None], zero, neg))
        pool_scores, sel = top_k_lowest_first(torch.cat([pool_scores, merge_scores], 1), k)
        pool_seqs = torch.cat([pool_seqs, parent], 1)[batch_idx[:, None], sel]
        pool_finished = torch.cat([pool_finished, did_finish], 1)[batch_idx[:, None], sel]

        # the running beams: the best K candidates that did not finish
        beam_scores, order = top_k_lowest_first(top_scores + torch.where(hits, neg, zero), k)
        new_token = token.gather(1, order).reshape(bk)
        flat_src = (batch_idx[:, None] * k + src_beam.gather(1, order)).reshape(bk)
        generated = generated[flat_src]
        generated[:, step] = new_token
        seen = seen[flat_src]
        seen[torch.arange(bk, device=dev), new_token] = True

        # sticky early-stop heuristic (HF _check_early_stop_heuristic at
        # cur_len = step + 1)
        best_possible = beam_scores[:, 0] / steps ** lp
        worst_pool = torch.where(pool_finished.all(1), pool_scores.min(1).values, neg)
        unsat = unsat & (best_possible > worst_pool)

        if step + 1 < max_new:
            cache_mask = cache_mask[flat_src]
            caches = [(c[0][flat_src], c[1][flat_src]) for c in caches]
            last_logits, caches = _decode_step(params, lm_config, new_token, caches, cache_mask,
                                               lengths_k + step, t0 + step, inputs_embeds.dtype)
    # pool slot 0 is the best finished hypothesis; at the last step every
    # running beam retired, so the pool is never empty
    return pool_seqs[:, 0, :]


def generate(params: dict, lm_config, inputs_embeds: torch.Tensor,
             attention_mask: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    if config.num_beams <= 1:
        return greedy_generate(params, lm_config, inputs_embeds, attention_mask, config)
    return beam_generate(params, lm_config, inputs_embeds, attention_mask, config)
