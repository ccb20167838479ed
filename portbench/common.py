"""What every driver of the benchmark shares: the cell's files found by
name, the run's settings, the word tokenizer of the captions, the profiler
pass, the per-layer readers, and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
import time
import zlib
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "aat_tpu")
GIB = float(1 << 30)


def process_start() -> float:
    """The wall time at which this process started (from ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """One run of one cell: its files, the command line's settings and the
    device."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float
    control: bool = False  # calibration: run the reference's control beside it


def cell_run(name: str, seed: int, seconds: float, trace: bool, device, started: float,
             cell: Optional[dict] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> Run:
    """The run of the workload file ``workloads/<name>.json`` and the
    configuration and traffic files it names (or the given ones)."""
    cell = cell or load_json("workloads", f"{name}.json")
    config = config or load_json("configs", f"{cell['config']}.json")
    traffic = traffic or load_json("traffic", f"{cell['traffic']}.json")
    return Run(name, cell, config, traffic, seed, seconds, trace, device, started)


class WordTokenizer:
    """The captions' tokenizer: one id per word (a CRC of the word over the
    vocabulary, ids 0-2 kept for pad, BOS and EOS), BOS and EOS as the
    strings ``<s>`` and ``</s>``; right padding with 0."""

    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2
    _SPECIAL = {1: "<s>", 2: "</s>"}

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def decode(self, ids) -> str:
        return "".join(self._SPECIAL.get(int(i), f"w{int(i)}") for i in ids)

    def word_id(self, word: str) -> int:
        if word == "<s>":
            return 1
        if word == "</s>":
            return 2
        return zlib.crc32(word.encode()) % (self.vocab_size - 3) + 3

    def __call__(self, texts, padding=True) -> dict:
        rows = [[self.word_id(w) for w in re.findall(r"<s>|</s>|[^\s<]+", t)] for t in texts]
        width = max(len(r) for r in rows)
        return {"input_ids": [r + [0] * (width - len(r)) for r in rows],
                "attention_mask": [[1] * len(r) + [0] * (width - len(r)) for r in rows]}


def synchronize(device):
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


class Profile:
    """A ``torch.profiler`` pass: device operations and host operations as
    ``(name, start_us, end_us)`` lists, and the traced window."""

    def __init__(self, device):
        self.device = device
        self.device_ops: List[tuple] = []
        self.host_ops: List[tuple] = []
        self.window_us = (0.0, 0.0)
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if getattr(self.device, "type", "cpu") == "cuda":
            acts.append(ProfilerActivity.CUDA)
        synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.device)
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        events = self._prof.events()
        for e in events:
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                self.device_ops.append(span)
            elif e.device_type == DeviceType.CPU:
                self.host_ops.append(span)
        starts = [s for _, s, _ in self.host_ops + self.device_ops]
        lo = min(starts) if starts else 0.0
        self.window_us = (lo, lo + wall * 1e6)
        return False


def load_reader(metric: str):
    """The per-layer metric's reader module ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_layer(bench: dict, cell: str, obs: dict) -> Dict[str, dict]:
    """Each per-layer metric of ``cell`` that its reader finds something to
    read for, ``{name: {"value", "unit"}}``."""
    out = {}
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        value = load_reader(m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(bench: dict, cell: str, values: dict) -> Dict[str, dict]:
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell]) and values.get(m["name"]) is not None}


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def judge(checks: Dict[str, dict]) -> bool:
    """Correct when every number compared is within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict[str, dict]):
    """Each number compared beside its limit, as the last lines on standard
    error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)

