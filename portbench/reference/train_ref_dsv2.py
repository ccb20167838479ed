"""The plain reference of the first training steps of the HuBERT →
DeepSeek-V2 ASLM: ``train_ref``'s steps (caption cross-entropy, dropout and
LayerDrop by the configuration's rules, AdamW in float32 on the trained
leaves, the LM frozen) with the decoder of ``reference/deepseek_v2`` and
the weights of ``drivers/train_dsv2``'s specs. It also returns the first
step's routing (each expert layer's sorted top-k choices, by microbatch),
which the run compares with the program's."""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from portbench.reference import deepseek_v2 as ref_lm
from portbench.reference import hashing as hsh
from portbench.reference import model as ref
from portbench.reference import train_ref
from portbench import weights as wt


def microbatch_loss(params: dict, config: dict, batch: dict, step_seed: int, ar: ref.Arith,
                    row_block: int, device, routes=None) -> float:
    """``train_ref.microbatch_loss`` with the DeepSeek-V2 decoder."""
    enc = config["hubert"]
    ids_all = torch.as_tensor(batch["input_ids"], device=device).long()
    cmask_all = torch.as_tensor(batch["input_ids_attention_mask"], device=device)
    count = float(cmask_all[:, 1:].sum())
    s_enc = hsh.fold_seed(step_seed, 0)
    total = 0.0
    blocks = []  # each row block's routes, joined by layer below
    for r0 in range(0, ids_all.shape[0], row_block):
        r1 = min(ids_all.shape[0], r0 + row_block)
        wave = torch.as_tensor(batch["waveforms"][r0:r1], device=device).float()
        smask = torch.as_tensor(batch["waveforms_attention_mask"][r0:r1], device=device)
        frames, fmask = ref.hubert(params["audio_encoder"], enc, wave, smask, s_enc, ar, r0)
        projected = ref.project(params["adapter"], frames, fmask, ar)
        ids, cmask = ids_all[r0:r1], cmask_all[r0:r1]
        text = params["lm_decoder"]["embed_tokens"]["embedding"][ids]
        text_mask = torch.as_tensor(batch["attention_mask"][r0:r1], device=device)
        embeds, mask = ref.assemble(params["adapter"], projected, fmask, text, text_mask)
        t, cl = embeds.shape[1], ids.shape[1]
        positions = torch.arange(t, device=device)[None, :].expand(r1 - r0, t)
        block_routes = None if routes is None else []
        logits = ref_lm.decoder(params["lm_decoder"], config, embeds, mask, positions, ar,
                                head_from=t - cl, routes=block_routes)[:, :-1]
        if block_routes is not None:
            blocks.append(block_routes)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1),
                             reduction="none").reshape(ids.shape[0], cl - 1)
        block = (ce * cmask[:, 1:].float()).sum()
        (block / count).backward()
        total += float(block.detach())
        del frames, projected, embeds, logits, ce, block
    if routes is not None:
        routes.extend(torch.cat(layer) for layer in zip(*blocks))
    return total / count


def reference_steps(config: dict, seed: int, train_seed: int, steps_batches: List[List[dict]],
                    ar: ref.Arith, row_block: int, device, make_params) -> dict:
    """``train_ref.reference_steps`` with the DeepSeek-V2 decoder and the
    weights ``make_params(config, seed, device, subtrees=...)`` draws; adds
    ``routes``: the first step's routing, one list a microbatch."""
    trained = ("audio_encoder", "adapter")
    params = make_params(config, seed, device)
    leaves = list(wt.leaf_items({k: params[k] for k in trained}))
    for _, x in leaves:
        x.requires_grad_(True)
    m = [torch.zeros_like(x) for _, x in leaves]
    v = [torch.zeros_like(x) for _, x in leaves]
    losses, grad_norms, routes = [], {}, []
    count = 0
    for step, micro in enumerate(steps_batches):
        step_losses = []
        for i, mb in enumerate(micro):
            mb_routes = [] if step == 0 else None
            step_losses.append(microbatch_loss(params, config, mb,
                                               hsh.fold_seed(train_seed, step, i), ar, row_block,
                                               device, mb_routes))
            if mb_routes is not None:
                routes.append(mb_routes)
        losses.append(sum(step_losses) / len(step_losses))
        with torch.no_grad():
            grads = [(x.grad if x.grad is not None else torch.zeros_like(x)) / len(micro)
                     for _, x in leaves]
            for _, x in leaves:
                x.grad = None
            if step == 0:
                grad_norms = {p: float(g.norm()) for (p, _), g in zip(leaves, grads)}
            gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
            if not math.isfinite(gnorm):
                continue  # the guard drops a non-finite step
            lr = train_ref._lr(config, count)
            bc1, bc2 = 1.0 - train_ref.B1 ** (count + 1), 1.0 - train_ref.B2 ** (count + 1)
            for i, ((path, x), g) in enumerate(zip(leaves, grads)):
                m[i] = (1.0 - train_ref.B1) * g + train_ref.B1 * m[i]
                v[i] = (1.0 - train_ref.B2) * g * g + train_ref.B2 * v[i]
                direction = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + train_ref.EPS)
                if train_ref._decays(path, x):
                    direction = direction + config["weight_decay"] * x
                x.add_(-lr * direction)
            count += 1
            del grads
    del m, v
    start = make_params(config, seed, device, subtrees=trained)
    with torch.no_grad():
        change = {p: float((x - x0).norm()) for (p, x), (_, x0) in
                  zip(leaves, wt.leaf_items({k: start[k] for k in trained}))}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "routes": routes}


def route_flip_share(program_routes, reference_routes) -> float:
    """The share of the program's top-k choices (over every expert layer and
    token of the microbatches both ran) that the reference did not make; a
    layer whose tokens differ in number (another batch) counts as all missed."""
    missed = total = 0.0
    for mb_prog, mb_ref in zip(program_routes, reference_routes):
        for a, b in zip(mb_prog, mb_ref):
            a = a.to(b.device)
            total += a.numel()
            if a.shape != b.shape:
                missed += a.numel()
                continue
            missed += float((~(a[:, :, None] == b[:, None, :]).any(-1)).sum())
    return missed / total if total else 1.0


def compare(program: dict, reference: dict) -> dict:
    """``train_ref.compare``'s numbers and ``route_flip_share``."""
    out = train_ref.compare(program, reference)
    out["route_flip_share"] = route_flip_share(program.get("routes", []),
                                               reference.get("routes", []))
    return out
