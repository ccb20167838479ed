"""The plain reference of the first training steps: the ASLM's caption
cross-entropy over the same microbatches, its gradients with dropout and
LayerDrop drawn as the configuration's rules say, averaged over the
accumulated microbatches, and AdamW (the published weight-decay groups,
linear warmup, bias correction) in float32 on the trained leaves, the LM
frozen. Rows run in blocks, so a batch of long utterances fits; each block
draws its rows' masks of the whole batch.

Returns what the run compares: each step's loss, the first step's gradient
norm of every trained leaf, and each trained leaf's change after the last
step."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench import weights as wt
from portbench.reference import hashing as hsh
from portbench.reference import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def _lr(config: dict, count: int) -> float:
    """The warmup-linear schedule at the step after ``count`` applied steps."""
    base, warm = config["learning_rate"], max(config["warmup_steps"], 1)
    total = config.get("max_steps") or 100000
    s = count + 1.0
    if s > total:
        return config["start_lr_from"]
    if s > warm:
        return base - (s - warm) * (base - config["start_lr_from"]) / max(total - warm, 1)
    return base * s / warm


def _decays(path: str, leaf: torch.Tensor) -> bool:
    name = path.lower()
    return not ("bias" in name or "norm" in name or "scale" in name) and leaf.ndim >= 2


def microbatch_loss(params: dict, config: dict, batch: dict, step_seed: int, ar: ref.Arith,
                    row_block: int, device) -> float:
    """The microbatch's mean caption CE; its gradient (over the count of
    the whole microbatch's caption tokens) added to the trained leaves'
    ``.grad``, one block of rows at a time."""
    enc, lm = config["hubert"], config["lm"]
    ids_all = torch.as_tensor(batch["input_ids"], device=device).long()
    cmask_all = torch.as_tensor(batch["input_ids_attention_mask"], device=device)
    count = float(cmask_all[:, 1:].sum())
    s_enc = hsh.fold_seed(step_seed, 0)
    total = 0.0
    rows = ids_all.shape[0]
    for r0 in range(0, rows, row_block):
        r1 = min(rows, r0 + row_block)
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
        logits = ref.llama(params["lm_decoder"], lm, embeds, mask, positions, ar,
                           head_from=t - cl)[:, :-1]
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1),
                             reduction="none").reshape(ids.shape[0], cl - 1)
        block = (ce * cmask[:, 1:].float()).sum()
        (block / count).backward()
        total += float(block.detach())
        del frames, projected, embeds, logits, ce, block
    return total / count


def reference_steps(config: dict, seed: int, train_seed: int, steps_batches: List[List[dict]],
                    ar: ref.Arith, row_block: int, device) -> dict:
    """``{"losses": [...], "grad_norms": {path: norm}, "change_norms":
    {path: norm}}`` of the steps over ``steps_batches`` (one list of
    microbatches a step), from the weights of ``seed``; ``train_seed`` keys
    the dropout of (step, microbatch)."""
    trained = ("audio_encoder", "adapter")
    params = wt.make_params(config, seed, device)
    leaves = [(p, x) for p, x in wt.leaf_items({k: params[k] for k in trained})]
    for _, x in leaves:
        x.requires_grad_(True)
    m = [torch.zeros_like(x) for _, x in leaves]
    v = [torch.zeros_like(x) for _, x in leaves]
    losses, grad_norms = [], {}
    count = 0
    for step, micro in enumerate(steps_batches):
        step_losses = [microbatch_loss(params, config, mb, hsh.fold_seed(train_seed, step, i), ar,
                                       row_block, device) for i, mb in enumerate(micro)]
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
            lr = _lr(config, count)
            bc1, bc2 = 1.0 - B1 ** (count + 1), 1.0 - B2 ** (count + 1)
            wd = config["weight_decay"]
            for i, ((path, x), g) in enumerate(zip(leaves, grads)):
                m[i] = (1.0 - B1) * g + B1 * m[i]
                v[i] = (1.0 - B2) * g * g + B2 * v[i]
                direction = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + EPS)
                if _decays(path, x):
                    direction = direction + wd * x
                x.add_(-lr * direction)
            count += 1
            del grads
    del m, v
    start = wt.make_params(config, seed, device, subtrees=trained)
    with torch.no_grad():
        change = {p: float((x - x0).norm()) for (p, x), (_, x0) in
                  zip(leaves, wt.leaf_items({k: start[k] for k in trained}))}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def _median(values) -> float:
    vals = sorted(values)
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2]) if n else 0.0


def leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """The worst leaf's gap of norms, ``|got - want|`` over the reference's
    norm of that leaf."""
    return max((abs(got[p] - want[p]) / max(want[p], 1e-30) for p in leaves), default=0.0)


def compare(program: dict, reference: dict, min_grad_share: float = 1e-3) -> dict:
    """The numbers compared: the loss gap (the worst step's, relative), and
    the first gradient's and the change's worst-leaf gaps, each over the
    leaves whose reference gradient is not nought to rounding (at least
    ``min_grad_share`` of the median leaf's)."""
    rl, pl = reference["losses"], program["losses"]
    n = min(len(rl), len(pl))
    loss_gap = max(abs(pl[i] - rl[i]) / abs(rl[i]) for i in range(n))
    g = reference["grad_norms"]
    g_floor = min_grad_share * _median(list(g.values()))
    moved = [p for p in g if g[p] >= g_floor]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(program["grad_norms"], g, moved),
            "change_gap": leaf_gap(program["change_norms"], reference["change_norms"], moved),
            "excluded_leaves": len(g) - len(moved)}
