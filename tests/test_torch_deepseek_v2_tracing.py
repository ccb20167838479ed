"""The DeepSeek-V2 decoder's tracing: ``timing.count_device`` adds a
device scalar when the table is read; under a profiler the expert layer
counts its (token, choice) pairs (``moe.pairs``) and those on held experts
(``moe.pairs_here``) once a forward, not again where remat recomputes it,
and marks ``moe.route``, ``moe.experts`` and ``mla.attention``; with no
profiler it counts nothing."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aat_tpu_torch.models import deepseek_v2 as dsv2
from aat_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def fresh_counters():
    timing.reset()
    yield
    timing.reset()


def test_count_device_adds_a_scalar_when_read():
    timing.count_device("x", torch.tensor(3))
    timing.count_device("x", 4)
    assert timing.counters() == {"x": 7.0}
    timing.reset()
    assert timing.counters() == {}


@pytest.mark.parametrize("remat", [False, True])
def test_expert_layer_counts_its_pairs_once_a_forward(remat):
    cfg = dataclasses.replace(dsv2.tiny_test_config(3, 2), remat=remat)
    params = dsv2.init_deepseek_v2_params(1, cfg)
    x = torch.randn(2, 9, cfg.hidden_size, requires_grad=True)
    dsv2.deepseek_v2_forward(params, cfg, inputs_embeds=x)[0].sum().backward()
    assert timing.counters() == {}  # no profiler: nothing counted or marked
    held = []
    real = dsv2.route

    def route(p, config, h):
        weights, experts = real(p, config, h)
        held.append(int(((experts >= 2) & (experts < 5)).sum()))
        return weights, experts

    dsv2.route = route
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            logits, _ = dsv2.deepseek_v2_forward(params, cfg, inputs_embeds=x)
            logits.sum().backward()
    finally:
        dsv2.route = real
    got = timing.counters()
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    assert len(held) == n_moe * (2 if remat else 1)  # remat routes again in the backward
    assert got["moe.pairs"] == n_moe * 18 * cfg.num_experts_per_tok
    assert got["moe.pairs_here"] == sum(held[:n_moe])
    names = {e.name for e in prof.events() if e.name.startswith("aat.")}
    assert {"aat.moe.route.begin", "aat.moe.experts.end", "aat.mla.attention.begin"} <= names
