"""LR schedule (counterpart of ``aat_tpu/training/lr_schedule.py``): linear
warmup to the base LR over ``warmup_steps``, linear anneal down to
``start_lr_from`` at ``max_steps``, then hold at ``start_lr_from``."""

from __future__ import annotations

import torch


def warmup_linear_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                           start_lr_from: float = 1e-5):
    """step (an int or an integer tensor) → lr as a float32 tensor on the
    step's device. Evaluated at ``step + 1``, as the JAX schedule is (torch
    schedulers count from 1); branchless, so a device step needs no sync."""

    def schedule(step):
        s = torch.as_tensor(step).to(torch.float32) + 1.0
        warm = base_lr * s / max(warmup_steps, 1)
        anneal_total = max(max_steps - warmup_steps, 1)
        decrement = (base_lr - start_lr_from) / anneal_total
        anneal = base_lr - (s - warmup_steps) * decrement
        start = torch.full_like(s, start_lr_from)
        return torch.where(s > max_steps, start, torch.where(s > warmup_steps, anneal, warm))

    return schedule
