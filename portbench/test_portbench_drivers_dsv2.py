"""The DeepSeek-V2 training driver end to end on the CPU at tiny widths
(the chip check skipped): the contract's result line, the routing the
reference compares, and the faults planted in the timed path that
``correct`` must catch."""

import time

import pytest
import torch

from portbench import calibrate_dsv2, common, run, tiny

LM = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 48,
      "moe_intermediate_size": 16, "num_hidden_layers": 3, "num_attention_heads": 4,
      "num_key_value_heads": 4, "n_routed_experts": 16, "num_experts_per_tok": 3,
      "experts_held": 4, "kv_lora_rank": 24, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
      "v_head_dim": 12}


def tiny_run(seed, seconds=1.0, limits=None):
    name = "train-longform.dsv2lite"
    cell = common.load_json("workloads", f"{name}.json")
    config = tiny.config(common.load_json("configs", f"{cell['config']}.json"))
    config.update(LM)
    del config["lm"]
    if limits:
        cell = dict(cell, check=dict(cell["check"], limits=limits))
    traffic = tiny.traffic(common.load_json("traffic", f"{cell['traffic']}.json"))
    return common.cell_run(name, seed, seconds, False, torch.device("cpu"), time.time(),
                           cell=cell, config=config, traffic=traffic)


# f32 on both sides at tiny widths: the program agrees with the reference
# to rounding; each fault moves a number far past these
LIMITS = {"grad_gap": 1e-3, "change_gap": 1e-2, "route_flip_share": 1e-3, "loss_gap": 1e-4,
          "expert_grad_gap": 1e-4}


def test_dsv2_driver_prints_the_contract_line(cpu_threads, capsys):
    from portbench.drivers import train_dsv2

    r = tiny_run(4_000_000_019, limits=LIMITS)
    out = train_dsv2.run(r)
    line = run.result_line(common.benchmark(), r, out)
    assert line["correct"] is True, out["readings"]["numbers"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_audio_s_per_s", "train_peak_gib"}
    assert out["readings"]["numbers"]["route_flip_share"] == 0.0
    assert out["readings"]["numbers"]["expert_grad_gap"] < 1e-5
    err = capsys.readouterr().err
    assert all(f"check {k}:" in err for k in line["checks"])


@pytest.mark.parametrize("fault", ["half_batch", "expert_offset", "expert_dx_zero"])
def test_dsv2_faults_are_not_correct(cpu_threads, fault):
    got = calibrate_dsv2.readings(tiny_run(99, seconds=0.3, limits=LIMITS), fault)
    assert got["correct"] is False, got["numbers"]


@pytest.mark.parametrize("fault", ["expert_offset", "expert_dx_zero"])
def test_expert_probe_sees_the_held_experts_faults(cpu_threads, fault):
    """The probe reads the routed experts alone: their weights shifted, or
    their input gradient zeroed, moves it to about 1."""
    from portbench.drivers import train_dsv2

    r = tiny_run(7)
    sound = train_dsv2.expert_probe(r.config, r.seed, r.device, control=True)
    assert sound["program"] < 1e-5 and sound["control"] > 1e-2
    with calibrate_dsv2.planted(fault):
        broken = train_dsv2.expert_probe(r.config, r.seed, r.device, control=False)
    assert broken["program"] > 0.5


def test_launch_log_bounds_both_widths():
    """Launches with one width take ``bounds`` (dropout included), those
    with q/k wider than v ``bounds_mla``; the latent bound is theirs alone."""
    from portbench.drivers import train_dsv2
    from portbench.yardstick import bounds, bounds_mla

    log = train_dsv2.LaunchLog.__new__(train_dsv2.LaunchLog)
    log.records = [("dq", "bfloat16", 1, 8499, 16, 16, 64, 64, 3.0e7, 0.1),
                   ("fwd", "bfloat16", 1, 8540, 16, 16, 192, 128, 3.6e7, 0.0)]
    dense = bounds.attention_seconds("dq", "bfloat16", 1, 8499, 16, 16, 64, 3.0e7, 0.1)
    latent = bounds_mla.attention_seconds("fwd", "bfloat16", 1, 8540, 16, 16, 192, 128, 3.6e7)
    assert log.latent_bound_seconds() == latent
    assert log.bound_seconds() == pytest.approx(dense + latent, rel=1e-12)
    log.records.append(("fwd", "bfloat16", 1, 99, 16, 16, 192, 128, 99.0, 0.1))
    with pytest.raises(ValueError, match="dropout"):
        log.latent_bound_seconds()


MOE_TABLE = {"span.train.step.calls": 2, "span.moe.route.device_s": 0.1,
             "span.moe.experts.device_s": 0.4, "span.mla.attention.device_s": 0.6,
             "moe.pairs": 4000, "moe.pairs_here": 500, "span.moe.experts.calls": 4}
MOE_READERS = ("moe.route_ms", "moe.experts_ms", "mla.attention_ms", "moe.held_pair_share",
               "moe.experts_roofline", "mla.attn_roofline")


def test_dsv2_readers_from_the_counter_table_and_trace(monkeypatch):
    from portbench.yardstick import peaks, spans

    monkeypatch.setattr(spans, "port_counters", lambda: MOE_TABLE)
    ops = [("cutlass::GroupProblemShape<...>", 0.0, 1000.0),
           ("flash_fwd_mma_kernel<192, 128, true>", 1000.0, 3000.0), ("other", 3000.0, 9000.0)]
    obs = {"device_ops": ops, "mla_bound_s": 1e-3,
           "moe": {"hidden": 64, "width": 32, "held": 2}}
    got = {m: common.load_reader(m).read(obs) for m in MOE_READERS}
    flops_s = 12.0 * 500 * 64 * 32 / peaks.BF16_FLOPS
    bytes_s = 4 * 2 * 3 * 2 * 64 * 32 * 2 / peaks.HBM_BYTES_PER_S
    assert got == pytest.approx({"moe.route_ms": 50.0, "moe.experts_ms": 200.0,
                                 "mla.attention_ms": 300.0, "moe.held_pair_share": 12.5,
                                 "moe.experts_roofline": 100.0 * max(flops_s, bytes_s) / 1e-3,
                                 "mla.attn_roofline": 50.0})


@pytest.mark.parametrize("table", [None, {}])
def test_dsv2_readers_give_none_without_the_programs_tracing(monkeypatch, table):
    """The parent's program has no such spans and counters."""
    from portbench.yardstick import spans

    monkeypatch.setattr(spans, "port_counters", lambda: table)
    for metric in MOE_READERS:
        assert common.load_reader(metric).read({}) is None, metric
