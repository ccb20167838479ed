"""The DeepSeek-V2 decoder (``models/deepseek_v2``) against the plain
float32 reference of ``tests/reference_deepseek_v2.py`` on seeded random
weights at tiny widths on the CPU: latent attention and its input
gradients, the YaRN tables and scale at DeepSeek-V2-Lite's settings, the
MoE layer with every expert held, the expert shares of a 64-expert layer
summing to the uncut layer, the whole decoder's caption logits, prefill and
decode through the KV cache against the full forward, and the dispatch of
the (192, 128) bf16 operands to the latent-attention kernels' C entries on
the meta device."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import aat_tpu_torch.ops.attention as tatt
import reference_deepseek_v2 as ref
from aat_tpu_torch.models import decoders
from aat_tpu_torch.models import deepseek_v2 as dsv2
from test_torch_flash_fwd_mma import meta_library  # noqa: F401  (fixture)
from tests._torch_threads import two_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def params_and_config(held=8, offset=0, seed=3, **kw):
    cfg = dataclasses.replace(dsv2.tiny_test_config(held, offset), **kw)
    return dsv2.init_deepseek_v2_params(seed, cfg), cfg


def embeds_and_mask(b=2, t=11, h=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, h, generator=g)
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[-1, t - 3:] = 0
    return x, mask


def test_yarn_tables_and_scale_at_published_settings():
    """DeepSeek-V2-Lite: dims 10-23 ramp (floor 10.47, ceil 22.51), m =
    0.1·0.707·ln 40 + 1, scale 192^-0.5·m²; mscale ratio 1; frequencies
    extrapolated below the ramp and divided by 40 above it."""
    cfg = dsv2.deepseek_v2_lite_config(8)
    assert dsv2.yarn_correction_range(cfg) == (10, 23)
    assert abs(dsv2.yarn_mscale(40.0, 0.707) - 1.26080) < 1e-5
    assert abs(dsv2.softmax_scale(cfg) - 0.114721) < 1e-6
    inv = dsv2.yarn_inv_freq(cfg)
    extra = 1.0 / 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    torch.testing.assert_close(inv[:10], extra[:10])
    torch.testing.assert_close(inv[23:], extra[23:] / 40.0)
    torch.testing.assert_close(inv, ref.yarn_inv_freq(cfg))
    cos, sin = dsv2.rope_cos_sin(torch.arange(5)[None], cfg)
    assert cos.shape == (1, 5, 64) and float(cos[0, 0].min()) == 1.0  # mscale ratio 1


def test_mla_forward_and_input_gradients_against_reference():
    params, cfg = params_and_config()
    layer = params["layers"][0]["attention"]
    x, mask = embeds_and_mask()
    x.requires_grad_(True)
    positions = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    cos, sin = dsv2.rope_cos_sin(positions, cfg)
    bias = dsv2.causal_mask_bias(mask, x.shape[1], x.shape[1], 0)
    got = dsv2._attention(layer, cfg, x, cos, sin, bias, None, 0, mask)
    want = ref.attention(layer, cfg, x, positions, mask)
    torch.testing.assert_close(got, want, **TOL)
    g = torch.randn_like(got)
    (gx,) = torch.autograd.grad(got, x, g)
    (wx,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(gx, wx, **TOL)


def test_mla_flash_route_bf16_against_reference(monkeypatch):
    """bf16 operands at T >= MIN_PALLAS_SEQ_LEN take the causal flash route
    (q/k 24 wide, v 12 here; on the CPU its plain version), within bf16
    rounding of the f32 reference."""
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    params, cfg = params_and_config(attention_impl="pallas")
    layer = params["layers"][0]["attention"]
    x, mask = embeds_and_mask()
    positions = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    cos, sin = dsv2.rope_cos_sin(positions, cfg)
    calls = []
    real = tatt.flash_attention_bthd
    monkeypatch.setattr(tatt, "flash_attention_bthd",
                        lambda q, k, v, *a: calls.append((q.shape, k.shape, v.shape))
                        or real(q, k, v, *a))
    layer16 = {k: {n: t.bfloat16() for n, t in p.items()} for k, p in layer.items()}
    got = dsv2._attention(layer16, cfg, x.bfloat16(), cos, sin, None, None, 0, mask)
    assert calls == [((2, 11, 4, 24), (2, 11, 4, 24), (2, 11, 4, 12))]
    want = ref.attention(layer, cfg, x, positions, mask)
    assert float((got.float() - want).norm() / want.norm()) < 2e-2


def test_moe_every_expert_held_against_reference():
    params, cfg = params_and_config(held=8)
    moe = params["layers"][1]["moe"]
    x, _ = embeds_and_mask(t=13)
    x.requires_grad_(True)
    got = dsv2._moe(moe, cfg, x)
    want = ref.moe(moe, cfg, x, 8, 0)
    torch.testing.assert_close(got, want, **TOL)
    g = torch.randn_like(got)
    torch.testing.assert_close(torch.autograd.grad(got, x, g)[0],
                               torch.autograd.grad(want, x, g)[0], **TOL)


def test_expert_shares_sum_to_the_uncut_layer():
    """A 64-expert layer (top-6) cut into 8 shares of 8 (offsets 0, 8, ...,
    56): the shares' outputs summed, the shared experts counted once, equal
    the reference layer that holds all 64."""
    cfg = dataclasses.replace(dsv2.tiny_test_config(64, 0), n_routed_experts=64,
                              num_experts_per_tok=6)
    full = dsv2.init_deepseek_v2_params(5, cfg)["layers"][1]["moe"]
    x, _ = embeds_and_mask(t=17)
    shared = ref.mlp(full["shared"], x)
    total = shared.clone()
    for offset in range(0, 64, 8):
        share_cfg = dataclasses.replace(cfg, experts_held=8, expert_offset=offset)
        share = dict(full, experts={k: w[offset:offset + 8] for k, w in full["experts"].items()})
        total = total + dsv2._moe(share, share_cfg, x) - shared
    torch.testing.assert_close(total, ref.moe(full, cfg, x, 64, 0), **TOL)
    # a share is not the whole: experts outside it add nothing
    one = dataclasses.replace(cfg, experts_held=8, expert_offset=8)
    part = dsv2._moe(dict(full, experts={k: w[8:16] for k, w in full["experts"].items()}),
                     one, x)
    assert float((part - total).abs().max()) > 1e-4


def test_decoder_caption_logits_against_reference():
    params, cfg = params_and_config(held=4, offset=2)
    x, mask = embeds_and_mask()
    logits, _ = decoders.forward(params, cfg, inputs_embeds=x, attention_mask=mask,
                                 logit_caption_len=5)
    want = ref.decoder(params, cfg, x, mask)
    assert logits.shape == (2, 4, cfg.vocab_size)
    torch.testing.assert_close(logits, want[:, -5:-1], **TOL)


def test_prefill_then_decode_logits_equal_the_full_forward():
    """Prefill 6 positions into the KV cache, then decode 5 one at a time:
    each step's logits equal the reference's full forward at its position
    (logits, not tokens: random weights tie on rounding)."""
    params, cfg = params_and_config(held=4, offset=4)
    x, _ = embeds_and_mask(b=2, t=11)
    full = ref.decoder(params, cfg, x, torch.ones(2, 11, dtype=torch.int32))
    caches = decoders.init_kv_caches(cfg, 2, 11, torch.float32)
    assert caches[0][0].shape == (2, 4, 11, 24) and caches[0][1].shape == (2, 4, 11, 12)
    mask = torch.zeros(2, 11, dtype=torch.int32)
    mask[:, :6] = 1
    logits, caches = decoders.forward(params, cfg, inputs_embeds=x[:, :6], attention_mask=mask,
                                      kv_caches=caches, cache_index=0)
    torch.testing.assert_close(logits, full[:, :6], **TOL)
    for slot in range(6, 11):
        mask[:, slot] = 1
        step, caches = decoders.forward(params, cfg, inputs_embeds=x[:, slot:slot + 1],
                                        attention_mask=mask, kv_caches=caches, cache_index=slot)
        torch.testing.assert_close(step[:, 0], full[:, slot], **TOL)


def test_routing_makes_no_host_copy(monkeypatch):
    """The MoE layer's routing, permutation and combine never read a device
    value on the host: ``Tensor.item``, ``tolist`` and ``__bool__`` /
    ``__int__`` are not called."""
    params, cfg = params_and_config()
    x, _ = embeds_and_mask()
    for name in ("item", "tolist", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, name=name: pytest.fail(name))
    dsv2._moe(params["layers"][1]["moe"], cfg, x)


def test_grouped_product_skips_frozen_weight_gradients(monkeypatch):
    """Through a frozen expert (weights without a gradient) the backward runs
    one grouped product per projection, for the input gradient only."""
    params, cfg = params_and_config()
    x, _ = embeds_and_mask()
    x.requires_grad_(True)
    calls = []
    real = torch._grouped_mm
    monkeypatch.setattr(torch, "_grouped_mm",
                        lambda a, b, offs: calls.append((a.shape, b.shape)) or real(a, b,
                                                                                    offs=offs))
    out = dsv2._moe(params["layers"][1]["moe"], cfg, x)
    assert len(calls) == 3  # gate, up, down: one grouped product each
    out.sum().backward()
    assert len(calls) == 6 and all(len(b) == 3 for _, b in calls)


# ---------------------------------------------------------------------------
# the (192, 128) kernels' dispatch, on the meta device
# ---------------------------------------------------------------------------


def mla_operands(t, dtype=torch.bfloat16):
    q, k = (torch.empty((1, t, 16, 192), dtype=dtype, device="meta") for _ in range(2))
    v = torch.empty((1, t, 16, 128), dtype=dtype, device="meta")
    return q, k, v, torch.ones((1, t), dtype=torch.int32, device="meta")


@pytest.mark.parametrize("t, entries", [
    (999, ["aat_flash_fwd_mma", "aat_flash_bwd_dq_mma", "aat_flash_bwd_dkv_mma"]),
    (8540, ["aat_flash_fwd_mma", "aat_flash_bwd_dq_mma", "aat_flash_bwd_dkv_mma"])])
def test_latent_widths_dispatch_to_the_mma_entries(meta_library, t, entries):
    """bf16 q/k 192 wide and v 128 wide go to the ``*_mma`` entries with D =
    192 and DV = 128 (fused backward up to 8192 keys, split past it); out
    and dv are 128 wide, dq and dk 192."""
    q, k, v, mask = mla_operands(t)
    split = tatt.flash_backward_dq_long.launches
    out, lse = tatt.flash_forward(q, k, v, mask, 0.1147, True, 0.0, 0, None, need_lse=True)
    assert out.shape == (1, t, 16, 128)
    dq, dk, dv = tatt.flash_backward(q, k, v, mask, out, lse, torch.empty_like(out), 0.1147,
                                     True, 0.0, 0, None)
    assert meta_library.names == entries
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert tatt.flash_backward_dq_long.launches == split + (t > tatt.FUSED_BWD_MAX_S)
    for name, args in zip(meta_library.names, meta_library.args):
        at = {"aat_flash_fwd_mma": 6, "aat_flash_bwd_dq_mma": 8, "aat_flash_bwd_dkv_mma": 10}
        assert args[at[name]: at[name] + 7] == (1, t, t, 16, 16, 192, 128)


@pytest.mark.parametrize("case", ["dense", "f32", "v192", "d160"])
def test_latent_widths_refused_off_their_kernels(meta_library, case):
    """(192, 128) is built for bf16 and causal only; other widths raise."""
    q, k, v, mask = mla_operands(300, torch.float32 if case == "f32" else torch.bfloat16)
    if case == "v192":
        v = torch.empty_like(q)
    if case == "d160":
        q, k = q[..., :160], k[..., :160]
    with pytest.raises(ValueError, match="flash kernel takes"):
        tatt.flash_forward(q, k, v, mask, 0.1, case != "dense", 0.0, 0, None, False)
    assert meta_library.names == []


def test_decoder_dispatch_keeps_llama():
    """Llama configs go to ``llama_forward`` unchanged; DeepSeek-V2 refuses
    packing."""
    from aat_tpu_torch.models import llama as llm

    assert decoders.decoder_type(llm.tiny_test_config()) == decoders.LLAMA
    params, cfg = params_and_config()
    x, mask = embeds_and_mask()
    with pytest.raises(ValueError, match="pack"):
        decoders.forward(params, cfg, inputs_embeds=x, attention_mask=mask, pack_len=4)
    lite = dsv2.deepseek_v2_lite_config(8)
    n_moe = sum(lite.is_moe_layer(i) for i in range(lite.num_hidden_layers))
    assert (n_moe, lite.qk_head_dim, math.isclose(dsv2.softmax_scale(lite), 0.114721,
                                                  abs_tol=1e-6)) == (26, 192, True)
    assert np.isfinite(float(dsv2.yarn_inv_freq(lite).sum()))


@pytest.mark.parametrize("kind", [decoders.LLAMA, decoders.DEEPSEEK_V2])
def test_train_step_flops_count_the_dispatched_decoder(kind):
    """``aslm_train_step_flops`` counts the LM by the decoder dispatch: the
    DeepSeek-V2 count for its config, the Llama one otherwise."""
    from aat_tpu_torch.models import llama as llm
    from aat_tpu_torch.models.aslm import AslmConfig
    from aat_tpu_torch.models.hubert import hubert_large_config
    from aat_tpu_torch.utils import flops

    lm = dsv2.deepseek_v2_lite_config(8) if kind == decoders.DEEPSEEK_V2 else llm.tiny_test_config()
    count = (flops.deepseek_v2_forward_flops if kind == decoders.DEEPSEEK_V2
             else flops.llama_forward_flops)
    got = flops.aslm_train_step_flops(hubert_large_config(), lm,
                                      AslmConfig(lm_hidden=lm.hidden_size), 1, None, 16000, 7)
    assert got["lm_fwd"] == count(lm, 1, got["lm_seq"])
