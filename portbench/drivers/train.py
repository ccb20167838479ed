"""The training driver: the port's ``AATTrainer.training_step`` fed by its
data layer (``NoSegmentationAudioWaveformCollator`` under ``BatchIterator``
with its prefetch thread) over a corpus made from the seed.

Set-up builds one trainer, drives it from the seed through its first steps
with the window's own call and feed, records what the reference will
judge, and hands the same trainer to the window. The window runs whole
steps until ``--seconds`` have passed. After it, the program's state is
freed and the plain reference follows the first steps from the same
weights and raw items.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from portbench import common
from portbench import weights as wt
from portbench.reference import collate as ref_collate
from portbench.reference import model as ref_model
from portbench.reference import train_ref
from portbench.yardstick import flops as yflops
from portbench.yardstick import waveform as ywave

SR = ywave.SAMPLING_RATE


def corpus(traffic: dict, seed: int):
    """The items of the run: ``items`` lengths spread evenly over
    ``length_s``, ordered by the seed; speech-like audio and caption words
    drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 1])
    n = traffic["items"]
    lo, hi = traffic["length_s"]
    secs = (lo + (hi - lo) * (np.arange(n) + 0.5) / n)[rng.permutation(n)]
    items = []
    for i, s in enumerate(secs):
        samples = int(round(s * SR))
        n_words = max(1, int(round(s * traffic["words_per_s"])))
        words = [f"w{int(k)}" for k in rng.integers(0, traffic["word_types"], n_words)]
        items.append({"id": i, "audio": {"array": ywave.speechlike(rng, samples),
                                         "sampling_rate": SR}, "words": words})
    return items


def model_configs(config: dict):
    from aat_tpu_torch.models.aslm import AslmConfig
    from aat_tpu_torch.models.hubert import HubertConfig
    from aat_tpu_torch.models.llama import LlamaConfig

    def build(cls, group):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in group.items()
                      if k in names})

    enc, lm = build(HubertConfig, config["hubert"]), build(LlamaConfig, config["lm"])
    enc = dataclasses.replace(enc, remat=config["encoder_remat"],
                              remat_policy=config["encoder_remat_policy"])
    aslm = AslmConfig(projection_type=config["projection_type"],
                      audio_encoder_embeddings_seq_len=config["audio_encoder_embeddings_seq_len"],
                      audio_encoder_hidden=enc.hidden_size, lm_hidden=lm.hidden_size,
                      projection_hidden=config["projection_hidden"])
    return enc, lm, aslm


def training_config(config: dict, seed: int):
    from aat_tpu_torch.training.config import TrainingConfig

    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    fields = {k: v for k, v in config.items() if k in names and k != "seed"}
    return TrainingConfig(**fields, seed=int(seed))


def feed(iterator):
    """Microbatches without end: one epoch after another."""
    while True:
        yield from iterator


class LaunchLog:
    """The flash launches of the traced steps, with their shapes and the
    (q, k) pairs their key masks allow (device scalars, read after the
    trace): the harness wraps the attention module's launch wrappers."""

    # wrapper: (kind, causal or the index of its argument, index of the
    # dropout rate), indices counted after the key mask
    NAMES = {"flash_forward_kernel": ("fwd", False, 1),
             "flash_forward_causal_kernel": ("fwd", True, 1),
             "flash_backward_kernel": ("bwd", False, 4),
             "flash_backward_causal_kernel": ("bwd", True, 4),
             "flash_backward_dq_long": ("dq", 4, 5), "flash_backward_dkv_long": ("dkv", 4, 5)}

    def __init__(self):
        from aat_tpu_torch.ops import attention as att

        self.att, self.saved, self.records, self.on = att, {}, [], False
        for name, how in self.NAMES.items():
            fn = getattr(att, name)
            self.saved[name] = fn
            setattr(att, name, self._wrap(fn, *how))

    def _wrap(self, fn, kind, causal, rate_at):
        from portbench.yardstick.bounds import allowed_pairs

        def wrapper(q, k, v, key_mask, *args):
            if self.on:
                is_causal = causal if isinstance(causal, bool) else bool(args[causal])
                b, t, h, d = q.shape
                self.records.append((kind, str(q.dtype)[6:], b, t, h, k.shape[2], d,
                                     allowed_pairs(key_mask, is_causal), float(args[rate_at])))
            return fn(q, k, v, key_mask, *args)

        # the wrapped function counts its launches on the module's name,
        # which is now the wrapper's; they go back to it on restore
        wrapper.launches = 0
        return wrapper

    def restore(self):
        for name, fn in self.saved.items():
            fn.launches += getattr(self.att, name).launches
            setattr(self.att, name, fn)

    def bound_seconds(self) -> float:
        from portbench.yardstick.bounds import attention_seconds

        total = 0.0
        for kind, dtype, b, t, h, kvh, d, pairs, rate in self.records:
            total += attention_seconds(kind, dtype, b, t, h, kvh, d, float(pairs), rate)
        return total


def run(r: common.Run) -> dict:
    from aat_tpu_torch.data.collate import NoSegmentationAudioWaveformCollator
    from aat_tpu_torch.data.dataloaders import BatchIterator
    from aat_tpu_torch.models.aslm import AslmModel
    from aat_tpu_torch.training.trainer import AATTrainer

    cfg, traffic, device = r.config, r.traffic, r.device  # the recipe's keys: cfg's top level
    setup_steps = r.cell["setup_steps"]
    tokenizer = common.WordTokenizer(cfg["lm"]["vocab_size"])
    items = corpus(traffic, r.seed)
    collate_seed = int(np.random.SeedSequence([int(r.seed) & (2**63 - 1), 2])
                       .generate_state(1)[0])
    collator = NoSegmentationAudioWaveformCollator(
        tokenizer, add_prefix=traffic["add_prefix"],
        noise_augmentation=traffic["noise_augmentation"], seed=collate_seed)
    batches = BatchIterator(items, collator, cfg["per_device_train_batch_size"],
                            shuffle=True, drop_last=True, seed=int(r.seed),
                            prefetch=traffic["prefetch"])
    stream = feed(batches)
    accum = cfg["gradient_accumulation_steps"]

    enc_cfg, lm_cfg, aslm_cfg = model_configs(cfg)
    params = wt.make_params(cfg, r.seed, device)
    model = AslmModel(aslm_cfg, enc_cfg, lm_cfg)
    trainer = AATTrainer(model, params, training_config(cfg, r.seed))
    del params

    def step(stats):
        t0 = time.perf_counter()
        micro = [next(stream) for _ in range(accum)]
        stats["wait_s"] += time.perf_counter() - t0
        metrics = trainer.training_step(micro)
        stats["audio_s"] += sum(float(mb["waveforms_attention_mask"].sum()) for mb in micro) / SR
        stats["shapes"].append([(mb["waveforms_attention_mask"].sum(-1).tolist(),
                                 mb["input_ids_attention_mask"].sum(-1).tolist()) for mb in micro])
        return metrics

    # set-up: the first steps through the window's call and feed; the
    # reference follows the first ``reference_steps`` of them
    check = r.cell["check"]
    trained = ("audio_encoder", "adapter")
    program = {"losses": []}
    setup_stats = {"wait_s": 0.0, "audio_s": 0.0, "shapes": []}
    skipped = 0.0
    for s in range(setup_steps):
        metrics = step(setup_stats)
        program["losses"].append(metrics["train/loss"])
        skipped = metrics["train/skipped_nonfinite_total"]
        if s == 0:  # the first gradient, from AdamW's first moment
            mu = {k: trainer.state.opt_state.mu[k] for k in trained}
            program["grad_norms"] = {p: float(x.norm()) / (1.0 - train_ref.B1)
                                     for p, x in wt.leaf_items(mu)}
            del mu
        if s == check["reference_steps"] - 1:
            start = wt.make_params(cfg, r.seed, device, subtrees=trained)
            now = dict(wt.leaf_items({k: trainer.state.params[k] for k in trained}))
            program["change_norms"] = {p: float((now[p] - x0).norm())
                                       for p, x0 in wt.leaf_items(start)}
            del start, now

    # the window: whole steps until the seconds have passed; with --trace
    # one profiler pass over a few steady steps inside it
    log = LaunchLog() if r.trace else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    stats = {"wait_s": 0.0, "audio_s": 0.0, "shapes": []}
    walls, traced_flags = [], []
    failed = 0
    prof = traced = None
    trace_first = r.cell.get("trace_after_steps", 1)
    trace_end = trace_first + r.cell.get("trace_steps", 1)
    common.synchronize(device)
    setup_s = time.time() - r.started
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds or not walls:
        if r.trace and len(walls) == trace_first:
            log.on = True
            prof = common.Profile(device).__enter__()
        t_step = time.perf_counter()
        metrics = step(stats)
        walls.append(time.perf_counter() - t_step)
        traced_flags.append(prof is not None)
        failed += int(metrics["train/skipped_nonfinite_total"] > skipped)
        skipped = metrics["train/skipped_nonfinite_total"]
        if prof is not None and len(walls) == trace_end:
            prof.__exit__(None, None, None)
            log.on, traced, prof = False, prof, None
    if prof is not None:  # the window ended inside the traced steps
        prof.__exit__(None, None, None)
        log.on, traced = False, prof
    common.synchronize(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    e2e = {"setup_s": setup_s, "train_audio_s_per_s": stats["audio_s"] / window,
           "train_peak_gib": peak / common.GIB}
    step_flops = [sum(yflops.train_row_flops(cfg, n, t) for samples, texts in micro
                      for n, t in zip(samples, texts)) for micro in stats["shapes"]]
    untraced = [i for i, f in enumerate(traced_flags) if not f]
    obs = {"cell": r.name, "device_type": device.type, "window_s": window, "steps": len(walls),
           "data_wait_s": stats["wait_s"],
           # the steps outside the profiler pass: their model FLOPs and walls
           "model_flops": sum(step_flops[i] for i in untraced),
           "model_s": sum(walls[i] for i in untraced)}
    out = {"attempted": len(walls), "failed": failed, "e2e": e2e, "obs": obs,
           "memory_peak_bytes": peak}
    if traced is not None:
        obs.update(trace_obs(traced, log))
    if log is not None:
        log.restore()

    # free the program, then the reference follows the first steps
    del trainer, model, batches, stream
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n_mb = check["reference_steps"] * accum
    order = ref_collate.batch_order(len(items), cfg["per_device_train_batch_size"],
                                    int(r.seed), n_mb)
    ref_batches = ref_collate.collate_batches(items, order, tokenizer, collate_seed,
                                              traffic["noise_augmentation"],
                                              traffic["add_prefix"])
    steps_batches = [ref_batches[i: i + accum] for i in range(0, n_mb, accum)]
    t_ref = time.perf_counter()
    reference = train_ref.reference_steps(cfg, r.seed, r.seed, steps_batches, ref_model.Arith(),
                                          check["row_block"], device)
    numbers = train_ref.compare(program, reference)
    out["reference_s"] = time.perf_counter() - t_ref
    if r.control:
        control = train_ref.reference_steps(cfg, r.seed, r.seed, steps_batches,
                                            ref_model.Arith(fp8=True), check["row_block"], device)
        out["control"] = train_ref.compare(control, reference)
        out["control_readings"] = control
    limits = check["limits"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    out["readings"] = {"program": program, "reference": reference, "numbers": numbers}
    return out


def trace_obs(traced: common.Profile, log) -> dict:
    """What the per-layer readers take from a profiler pass (and, given the
    flash launches' log, their bound)."""
    from portbench.yardstick import trace as ytrace

    lo, hi = traced.window_us
    busy = ytrace.busy_us(traced.device_ops)
    return {"traced_window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "device_ops": traced.device_ops, "host_ops": traced.host_ops,
            "traced_window_us": (lo, hi),
            "attention_bound_s": log.bound_seconds() if log is not None else None,
            "breakdown": {"device_ops": ytrace.top_ops(traced.device_ops),
                          "idle_gaps": ytrace.gaps_by_host(traced.device_ops, traced.host_ops,
                                                           lo, hi)}}
