"""The training driver of the HuBERT → DeepSeek-V2 ASLM: ``drivers/train``'s
run (the port's ``AATTrainer.training_step`` fed by its data layer, the set-up
steps the reference follows, the timed window, one profiler pass) with this
configuration's own pieces: the weight specs of its decoder, a launch log
that keeps the flash launches' two widths, its FLOP count
(``yardstick/flops_dsv2``), its reference (``reference/train_ref_dsv2``),
the routing of the first step, recorded for ``route_flip_share``, and the
held experts' input gradient on one expert layer, for ``expert_grad_gap``.

The configuration file carries the published DeepSeek-V2 keys at its top
level, the encoder under ``hubert``, and this chip's share of the routed
experts (``experts_held`` from ``expert_offset``).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from portbench import common
from portbench import weights as wt
from portbench.drivers import train as train_driver
from portbench.drivers.train import SR, corpus, feed, trace_obs, training_config
from portbench.reference import collate as ref_collate
from portbench.reference import deepseek_v2 as ref_lm
from portbench.reference import model as ref_model
from portbench.reference import train_ref_dsv2
from portbench.yardstick import flops_dsv2


def moe_layers(config: dict):
    return [i for i in range(config["num_hidden_layers"])
            if i >= config["first_k_dense_replace"] and i % config["moe_layer_freq"] == 0]


def lm_specs(config: dict):
    """The decoder's leaves in the port's tree: MLA's five products, the
    dense first layers' SwiGLU, the expert layers' router ``[experts,
    hidden]``, held experts stacked ``[held, in, out]`` and shared experts."""
    h, v, nh = config["hidden_size"], config["vocab_size"], config["num_attention_heads"]
    nope, rope, dv, rank = (config["qk_nope_head_dim"], config["qk_rope_head_dim"],
                            config["v_head_dim"], config["kv_lora_rank"])
    w, held = config["moe_intermediate_size"], config["experts_held"]
    moe = set(moe_layers(config))

    def mlp(p, width):
        return (wt._dense(p + ("gate",), h, width, False) + wt._dense(p + ("up",), h, width, False)
                + wt._dense(p + ("down",), width, h, False))

    specs = [(("embed_tokens", "embedding"), (v, h), "normal")]
    for layer in range(config["num_hidden_layers"]):
        p = ("layers", layer)
        a = p + ("attention",)
        specs += wt._norm(p + ("input_norm",), h, bias=False)
        specs += wt._dense(a + ("q",), h, nh * (nope + rope), False)
        specs += wt._dense(a + ("kv_a",), h, rank + rope, False)
        specs += wt._norm(a + ("kv_norm",), rank, bias=False)
        specs += wt._dense(a + ("kv_b",), rank, nh * (nope + dv), False)
        specs += wt._dense(a + ("out",), nh * dv, h, False)
        specs += wt._norm(p + ("post_attention_norm",), h, bias=False)
        if layer in moe:
            m = p + ("moe",)
            specs.append((m + ("router", "weight"), (config["n_routed_experts"], h), "normal"))
            specs += [(m + ("experts", "gate"), (held, h, w), "normal"),
                      (m + ("experts", "up"), (held, h, w), "normal"),
                      (m + ("experts", "down"), (held, w, h), "normal")]
            specs += mlp(m + ("shared",), w * config["n_shared_experts"])
        else:
            specs += mlp(p + ("mlp",), config["intermediate_size"])
    specs += wt._norm(("final_norm",), h, bias=False)
    return specs + wt._dense(("lm_head",), h, v, False)


def specs_of(config: dict):
    adapter = {"hubert": config["hubert"], "lm": {"hidden_size": config["hidden_size"]},
               "projection_hidden": config["projection_hidden"]}
    return {"audio_encoder": wt.encoder_specs(config["hubert"]),
            "adapter": wt.adapter_specs(adapter), "lm_decoder": lm_specs(config)}


def make_params(config: dict, seed: int, device, subtrees=wt.SUBTREES) -> dict:
    specs = specs_of(config)
    return {name: wt.make_subtree(specs[name], seed, name, device) for name in subtrees}


def lm_config(config: dict):
    """The port's decoder config of the file's published keys and share."""
    from aat_tpu_torch.utils.port import deepseek_v2_config_from_hf

    cfg = deepseek_v2_config_from_hf(config, config["experts_held"], config["expert_offset"])
    return dataclasses.replace(cfg, attention_impl=config["attention_impl"],
                               remat=config["lm_remat"])


def model_configs(config: dict):
    from aat_tpu_torch.models.aslm import AslmConfig
    from aat_tpu_torch.models.hubert import HubertConfig

    names = {f.name for f in dataclasses.fields(HubertConfig)}
    enc = HubertConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["hubert"].items() if k in names})
    enc = dataclasses.replace(enc, remat=config["encoder_remat"],
                              remat_policy=config["encoder_remat_policy"])
    aslm = AslmConfig(projection_type=config["projection_type"],
                      audio_encoder_embeddings_seq_len=config["audio_encoder_embeddings_seq_len"],
                      audio_encoder_hidden=enc.hidden_size, lm_hidden=config["hidden_size"],
                      projection_hidden=config["projection_hidden"])
    return enc, lm_config(config), aslm


class LaunchLog(train_driver.LaunchLog):
    """``drivers/train``'s log of the traced steps' flash launches with the
    v width kept beside the q/k one: the bound of every launch
    (``attn_roofline``: HuBERT's with ``yardstick/bounds``, dropout
    included, and the latent ones) and of the latent ones alone, q/k wider
    than v (``mla.attn_roofline``: ``yardstick/bounds_mla``, no dropout)."""

    def _wrap(self, fn, kind, causal, rate_at):
        from portbench.yardstick.bounds import allowed_pairs

        def wrapper(q, k, v, key_mask, *args):
            if self.on:
                is_causal = causal if isinstance(causal, bool) else bool(args[causal])
                b, t, h, dqk = q.shape
                self.records.append((kind, str(q.dtype)[6:], b, t, h, k.shape[2], dqk,
                                     v.shape[-1], allowed_pairs(key_mask, is_causal),
                                     float(args[rate_at])))
            return fn(q, k, v, key_mask, *args)

        wrapper.launches = 0
        return wrapper

    def _bound(self, latent_only: bool) -> float:
        from portbench.yardstick import bounds, bounds_mla

        total = 0.0
        for kind, dtype, b, t, h, kvh, dqk, dv, pairs, rate in self.records:
            if dqk != dv:
                if rate > 0.0:
                    raise ValueError("the latent launches' bound counts no dropout")
                total += bounds_mla.attention_seconds(kind, dtype, b, t, h, kvh, dqk, dv,
                                                      float(pairs))
            elif not latent_only:
                total += bounds.attention_seconds(kind, dtype, b, t, h, kvh, dqk, float(pairs),
                                                  rate)
        return total

    def bound_seconds(self) -> float:
        return self._bound(False)

    def latent_bound_seconds(self) -> float:
        return self._bound(True)


class RouteLog:
    """The program's routing while ``on``: each expert layer's sorted top-k
    choices, as the port's ``deepseek_v2.route`` returns them, in the
    forward only (not where remat recomputes a layer in the backward)."""

    def __init__(self):
        from aat_tpu_torch.models import deepseek_v2 as dsv2

        self.module, self.real, self.on, self.routes = dsv2, dsv2.route, False, []

        def route(p, config, x):
            weights, experts = self.real(p, config, x)
            if self.on and torch._C._current_graph_task_id() == -1:
                self.routes.append(experts.sort(-1).values.to(torch.int16))
            return weights, experts

        dsv2.route = route

    def restore(self):
        self.module.route = self.real


PROBE_ROWS = 8192  # about one microbatch's LM tokens


def expert_probe(cfg: dict, seed: int, device, control: bool) -> dict:
    """``expert_grad_gap``: the program's input gradient through the held
    experts of the first expert layer (``deepseek_v2._moe``: permutation,
    grouped products, combine, and their backward) against the reference's
    (``reference/deepseek_v2.routed``, f32), ‖dx − dx_ref‖ / ‖dx_ref‖, on
    ``PROBE_ROWS`` rows and a cotangent drawn from the seed in the LM's
    compute dtype. Both sides take the reference's f32 routing (routing is
    compared apart, by ``route_flip_share``) and leave the shared experts
    out, so the number reads the routed experts alone: a fault in their
    backward moves it to about 1, where the training step's gradients,
    which the shared experts and the residual stream carry too, move by a
    few percent. With ``control``, also the reference in float8 against
    its f32 (``"control"``)."""
    from aat_tpu_torch.models import deepseek_v2 as dsv2

    layer = moe_layers(cfg)[0]
    lm = make_params(cfg, seed, device, subtrees=("lm_decoder",))["lm_decoder"]
    moe = lm["layers"][layer]["moe"]
    router = moe["router"]["weight"].clone()
    experts = {name: w.clone() for name, w in moe["experts"].items()}
    del lm, moe
    dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed) & (2**63 - 1), 3])
                        .generate_state(1)[0]))
    h = cfg["hidden_size"]
    x = torch.randn(PROBE_ROWS, h, generator=gen, device=device).to(dtype)
    g = torch.randn(PROBE_ROWS, h, generator=gen, device=device).to(dtype)
    with torch.no_grad():
        weights, chosen = ref_lm.route({"weight": router}, cfg, x.float(), ref_model.Arith())

    def reference(ar):
        xr = x.float().requires_grad_(True)
        out = ref_lm.routed(experts, cfg, xr, weights, chosen, ar, torch.zeros_like(xr))
        return torch.autograd.grad(out, xr, g.float())[0]

    want = reference(ref_model.Arith())
    width = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]

    def zeros(n_in, n_out):
        return {"kernel": torch.zeros((n_in, n_out), dtype=dtype, device=device)}

    p = {"router": {"weight": router}, "experts": experts,
         "shared": {"gate": zeros(h, width), "up": zeros(h, width), "down": zeros(width, h)}}
    real = dsv2.route
    dsv2.route = lambda p_router, config, rows: (weights, chosen)
    try:
        xp = x.clone().requires_grad_(True)
        got = torch.autograd.grad(dsv2._moe(p, lm_config(cfg), xp), xp, g)[0].float()
    finally:
        dsv2.route = real

    def gap(dx):
        return float((dx - want).norm() / want.norm())

    out = {"program": gap(got)}
    if control:
        out["control"] = gap(reference(ref_model.Arith(fp8=True)))
    return out


def run(r: common.Run) -> dict:
    from aat_tpu_torch.data.collate import NoSegmentationAudioWaveformCollator
    from aat_tpu_torch.data.dataloaders import BatchIterator
    from aat_tpu_torch.models.aslm import AslmModel
    from aat_tpu_torch.training.trainer import AATTrainer

    cfg, traffic, device = r.config, r.traffic, r.device
    enc_cfg, dec_cfg, aslm_cfg = model_configs(cfg)
    setup_steps = r.cell["setup_steps"]
    tokenizer = common.WordTokenizer(cfg["vocab_size"])
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

    params = make_params(cfg, r.seed, device)
    model = AslmModel(aslm_cfg, enc_cfg, dec_cfg)
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

    check = r.cell["check"]
    trained = ("audio_encoder", "adapter")
    program = {"losses": []}
    setup_stats = {"wait_s": 0.0, "audio_s": 0.0, "shapes": []}
    skipped = 0.0
    routes = RouteLog()
    for s in range(setup_steps):
        routes.on = s == 0
        metrics = step(setup_stats)
        program["losses"].append(metrics["train/loss"])
        skipped = metrics["train/skipped_nonfinite_total"]
        if s == 0:
            mu = {k: trainer.state.opt_state.mu[k] for k in trained}
            program["grad_norms"] = {p: float(x.norm()) / (1.0 - train_ref_dsv2.train_ref.B1)
                                     for p, x in wt.leaf_items(mu)}
            del mu
        if s == check["reference_steps"] - 1:
            start = make_params(cfg, r.seed, device, subtrees=trained)
            now = dict(wt.leaf_items({k: trainer.state.params[k] for k in trained}))
            program["change_norms"] = {p: float((now[p] - x0).norm())
                                       for p, x0 in wt.leaf_items(start)}
            del start, now
    routes.restore()
    n_moe = len(moe_layers(cfg))
    program["routes"] = [routes.routes[i: i + n_moe]
                         for i in range(0, len(routes.routes), n_moe)]

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
    if prof is not None:
        prof.__exit__(None, None, None)
        log.on, traced = False, prof
    common.synchronize(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    e2e = {"setup_s": setup_s, "train_audio_s_per_s": stats["audio_s"] / window,
           "train_peak_gib": peak / common.GIB}
    step_flops = [sum(flops_dsv2.train_row_flops(cfg, n, t) for samples, texts in micro
                      for n, t in zip(samples, texts)) for micro in stats["shapes"]]
    untraced = [i for i, f in enumerate(traced_flags) if not f]
    obs = {"cell": r.name, "device_type": device.type, "window_s": window, "steps": len(walls),
           "data_wait_s": stats["wait_s"],
           "model_flops": sum(step_flops[i] for i in untraced),
           "model_s": sum(walls[i] for i in untraced),
           "moe": {"hidden": cfg["hidden_size"], "width": cfg["moe_intermediate_size"],
                   "held": cfg["experts_held"]}}
    out = {"attempted": len(walls), "failed": failed, "e2e": e2e, "obs": obs,
           "memory_peak_bytes": peak}
    if traced is not None:
        obs.update(trace_obs(traced, log))
        obs["mla_bound_s"] = log.latent_bound_seconds()
    if log is not None:
        log.restore()

    del trainer, model, batches, stream
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    probe = expert_probe(cfg, r.seed, device, r.control)
    n_mb = check["reference_steps"] * accum
    order = ref_collate.batch_order(len(items), cfg["per_device_train_batch_size"],
                                    int(r.seed), n_mb)
    ref_batches = ref_collate.collate_batches(items, order, tokenizer, collate_seed,
                                              traffic["noise_augmentation"],
                                              traffic["add_prefix"])
    steps_batches = [ref_batches[i: i + accum] for i in range(0, n_mb, accum)]
    t_ref = time.perf_counter()
    reference = train_ref_dsv2.reference_steps(cfg, r.seed, r.seed, steps_batches,
                                               ref_model.Arith(), check["row_block"], device,
                                               make_params)
    numbers = train_ref_dsv2.compare(program, reference)
    numbers["expert_grad_gap"] = probe["program"]
    out["reference_s"] = time.perf_counter() - t_ref
    if r.control:
        control = train_ref_dsv2.reference_steps(cfg, r.seed, r.seed, steps_batches,
                                                 ref_model.Arith(fp8=True), check["row_block"],
                                                 device, make_params)
        out["control"] = train_ref_dsv2.compare(control, reference)
        out["control"]["expert_grad_gap"] = probe["control"]
        out["control_readings"] = {k: v for k, v in control.items() if k != "routes"}
    limits = check["limits"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    program.pop("routes")
    reference.pop("routes")
    out["readings"] = {"program": program, "reference": reference, "numbers": numbers}
    return out
