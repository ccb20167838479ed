"""What the port's tracing costs a training step of a cell, at the cell's
own size, and which form of span the profiler keeps off the device.

    python3 portbench/trace_cost.py --workload <cell> --seed <n> [--rounds 5]

One trainer and one set of microbatches, built as the training driver
builds them, run in turns: a step with no profiler, a profiled step with
the port's spans, and a profiled step with ``span`` patched to the no-op.
Each wall is a step from a synchronised device to a synchronised device;
a profiled step's wall leaves out starting and stopping the profiler.
Then the spans a profiled step enters, the host microseconds of one empty
span (plain and on the device) while a profiler records, and their
product; and one profiled step with the spans made plain
``record_function`` ranges, the form the port does not use: the line
counts the CUDA-typed profiler events named ``aat.`` that each form leaves
among the device operations (Kineto's device-side annotations of ranges
that enclose launches).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import common  # noqa: E402


def build(r: common.Run):
    """``(trainer, microbatches of one step)`` of the run's cell, as the
    training driver makes them from its seed."""
    import numpy as np

    from aat_tpu_torch.data.collate import NoSegmentationAudioWaveformCollator
    from aat_tpu_torch.data.dataloaders import BatchIterator
    from aat_tpu_torch.models.aslm import AslmModel
    from aat_tpu_torch.training.trainer import AATTrainer
    from portbench import weights as wt
    from portbench.drivers import train

    cfg, traffic = r.config, r.traffic
    tokenizer = common.WordTokenizer(cfg["lm"]["vocab_size"])
    collate_seed = int(np.random.SeedSequence([int(r.seed) & (2**63 - 1), 2])
                       .generate_state(1)[0])
    collator = NoSegmentationAudioWaveformCollator(
        tokenizer, add_prefix=traffic["add_prefix"],
        noise_augmentation=traffic["noise_augmentation"], seed=collate_seed)
    batches = BatchIterator(train.corpus(traffic, r.seed), collator,
                            cfg["per_device_train_batch_size"], shuffle=True, drop_last=True,
                            seed=int(r.seed), prefetch=0)
    stream = iter(batches)
    micro = [next(stream) for _ in range(cfg["gradient_accumulation_steps"])]
    enc_cfg, lm_cfg, aslm_cfg = train.model_configs(cfg)
    trainer = AATTrainer(AslmModel(aslm_cfg, enc_cfg, lm_cfg),
                         wt.make_params(cfg, r.seed, r.device), train.training_config(cfg, r.seed))
    return trainer, micro


def step_wall(trainer, micro, device) -> float:
    common.synchronize(device)
    t0 = time.perf_counter()
    trainer.training_step(micro)
    common.synchronize(device)
    return time.perf_counter() - t0


class Profiled:
    """A profiled step: its wall, and the profiler's device and host
    operations."""

    def __init__(self, trainer, micro, device):
        with common.Profile(device) as prof:
            self.wall = step_wall(trainer, micro, device)
        self.device_ops, self.host_ops = prof.device_ops, prof.host_ops
        self.aat_on_device = sum(1 for name, _, _ in prof.device_ops if name.startswith("aat."))


def no_op_span(name, device=False):
    return contextlib.nullcontext()


def range_span(name, device=False):
    import torch

    return torch.profiler.record_function(f"aat.{name}")


def patched_span(replacement):
    """A context manager that swaps the port's ``timing.span``."""
    from unittest import mock

    from aat_tpu_torch.utils import timing

    return mock.patch.object(timing, "span", replacement)


def span_us(device, on_device: bool, n: int = 1000) -> float:
    """Host microseconds of one empty span while a profiler records."""
    from aat_tpu_torch.utils import timing

    with common.Profile(device):
        t0 = time.perf_counter()
        for _ in range(n):
            with timing.span("cost", device=on_device):
                pass
        elapsed = time.perf_counter() - t0
    return 1e6 * elapsed / n


def main(argv=None) -> int:
    import torch

    from aat_tpu_torch.utils import timing

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cost needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    r = common.cell_run(args.workload, args.seed, 0.0, True, device, time.time())
    trainer, micro = build(r)
    for _ in range(2):
        step_wall(trainer, micro, device)
    walls = {"untraced": [], "spans": [], "no_op": []}
    for i in range(args.rounds):
        order = ("untraced", "spans", "no_op") if i % 2 == 0 else ("no_op", "spans", "untraced")
        for kind in order:
            if kind == "untraced":
                walls[kind].append(step_wall(trainer, micro, device))
            elif kind == "spans":
                walls[kind].append(Profiled(trainer, micro, device).wall)
            else:
                with patched_span(no_op_span):
                    walls[kind].append(Profiled(trainer, micro, device).wall)
    timing.reset()
    spans_on = Profiled(trainer, micro, device)
    table = timing.counters()
    with patched_span(range_span):
        ranges = Profiled(trainer, micro, device)
    calls = {k[len("span."):-len(".calls")]: v for k, v in table.items() if k.endswith(".calls")}
    span_cost = {"plain": span_us(device, False), "device": span_us(device, True)}
    on_device = {name for name in calls if f"span.{name}.device_s" in table}
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device),
        "walls_s": walls, "median_s": med,
        "spans_cost_ms": 1e3 * (med["spans"] - med["no_op"]),
        "profiler_cost_ms": 1e3 * (med["no_op"] - med["untraced"]),
        "spans_a_step": calls, "span_us": span_cost,
        "spans_cost_from_span_us_ms": 1e-3 * sum(
            n * span_cost["device" if name in on_device else "plain"]
            for name, n in calls.items()),
        "aat_device_events": {"markers": spans_on.aat_on_device,
                              "ranges": ranges.aat_on_device}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
