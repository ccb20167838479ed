"""Decoder remat (``LlamaConfig.remat`` / ``remat_policy``, the no-cache
route; HuBERT's ``"full"`` and ``"dots"`` machinery): with either policy
the logits and every parameter and input gradient equal no remat's bit
for bit, on the plain route and on the causal flash route (forced, as
the training tests force it) and with packed rows; each layer's forward
runs again in the backward, ``"dots"`` re-running no product without
batch dimensions; the remat forward equals JAX's remat forward; and the
KV-cache route, which remat leaves alone, still equals JAX's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aat_tpu_torch.ops.attention as tatt
from aat_tpu.models import llama as jllm
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training import optim as toptim
from aat_tpu_torch.utils.port import to_tensors

from tests.test_torch_training_remat import CountOps


def _inputs(seed=0, b=2, t=10):
    rng = np.random.default_rng(seed)
    embeds = rng.normal(0, 0.5, (b, t, 32)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, 7:] = 0
    return embeds, mask


def forward_with_grads(cfg, params, embeds, mask, pack_len=None, caption_len=None):
    leaves = []

    def leaf(x):
        x = x.detach().clone().requires_grad_(True)
        leaves.append(x)
        return x

    p = toptim.tree_map(leaf, params)
    x = torch.from_numpy(embeds).requires_grad_(True)
    kw = {}
    if pack_len is not None:
        t = embeds.shape[1]
        kw = dict(pack_len=pack_len, positions=torch.arange(pack_len).repeat(t // pack_len)[None]
                  .expand(embeds.shape[0], t))
    logits, _ = tllm.llama_forward(p, cfg, inputs_embeds=x, attention_mask=torch.from_numpy(mask),
                                   logit_caption_len=caption_len, **kw)
    grads = torch.autograd.grad((logits ** 2).mean(), leaves + [x], allow_unused=True)
    return logits.detach(), grads


@pytest.mark.parametrize("route", ["plain", "flash", "packed"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_value_and_gradients_equal_no_remat(monkeypatch, policy, route):
    cfg = dataclasses.replace(tllm.tiny_test_config(),
                              attention_impl="xla" if route == "plain" else "pallas")
    if route != "plain":
        monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    params = tllm.init_llama_params(0, cfg)
    embeds, mask = _inputs()
    pack = 5 if route == "packed" else None
    if pack:
        mask[:] = 1
        mask[1, 8:] = 0
    out, grads = forward_with_grads(cfg, params, embeds, mask, pack, 4 if pack else None)
    cfg_r = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    out_r, grads_r = forward_with_grads(cfg_r, params, embeds, mask, pack, 4 if pack else None)
    assert torch.equal(out, out_r)
    assert len(grads) == len(grads_r)
    for g, g_r in zip(grads, grads_r):
        assert (g is None and g_r is None) or torch.equal(g, g_r)
    # the input and every layer's kernels get a gradient (the embedding
    # table, unused with inputs_embeds, none)
    assert sum(g is None for g in grads_r) == 1
    assert all(float(g.abs().max()) > 0 for g in grads_r if g is not None and g.ndim > 1)


def _backward_ops(cfg, params, embeds, mask):
    """The ops run in the backward of one forward, by name."""
    p = toptim.tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    logits, _ = tllm.llama_forward(p, cfg, inputs_embeds=torch.from_numpy(embeds),
                                   attention_mask=torch.from_numpy(mask))
    loss = (logits ** 2).mean()
    with CountOps(["mm", "addmm", "bmm", "silu", "rsqrt"]) as counts:
        loss.backward()
    return counts.count


def test_remat_recomputes_the_layers_in_the_backward():
    cfg = tllm.tiny_test_config()
    params = tllm.init_llama_params(0, cfg)
    embeds, mask = _inputs()
    plain = _backward_ops(cfg, params, embeds, mask)
    full = _backward_ops(dataclasses.replace(cfg, remat=True), params, embeds, mask)
    dots = _backward_ops(dataclasses.replace(cfg, remat=True, remat_policy="dots"), params,
                         embeds, mask)
    layers = cfg.num_hidden_layers
    # full: every layer's forward again (its 7 dense products, SiLU, 2 norms)
    assert full["silu"] == plain["silu"] + layers
    assert full["rsqrt"] >= plain["rsqrt"] + 2 * layers
    assert full["mm"] > plain["mm"] and full["bmm"] == plain["bmm"] + 2 * layers
    # dots: the products without batch dims kept, attention's bmm recomputed
    assert dots["mm"] + dots["addmm"] == plain["mm"] + plain["addmm"]
    assert dots["bmm"] == plain["bmm"] + 2 * layers and dots["silu"] == plain["silu"] + layers
    # without autograd a layer runs once
    with torch.no_grad():
        a, _ = tllm.llama_forward(params, dataclasses.replace(cfg, remat=True),
                                  inputs_embeds=torch.from_numpy(embeds),
                                  attention_mask=torch.from_numpy(mask))
    b, _ = tllm.llama_forward(params, cfg, inputs_embeds=torch.from_numpy(embeds),
                              attention_mask=torch.from_numpy(mask))
    assert torch.equal(a, b.detach())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_forward_equals_jax(policy):
    jcfg = dataclasses.replace(jllm.tiny_test_config(), remat=True, remat_policy=policy)
    tcfg = dataclasses.replace(tllm.tiny_test_config(), remat=True, remat_policy=policy)
    jparams = jllm.init_llama_params(0, jcfg)
    embeds, mask = _inputs(1)
    want, _ = jllm.llama_forward(jparams, jcfg, inputs_embeds=jnp.asarray(embeds),
                                 attention_mask=jnp.asarray(mask))
    got, grads = forward_with_grads(tcfg, to_tensors(jparams), embeds, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    # the KV-cache route ignores remat
    caches = tllm.init_kv_caches(tcfg, 2, 12)
    jcaches = jllm.init_kv_caches(jcfg, 2, 12)
    cache_mask = np.zeros((2, 12), np.int32)
    cache_mask[:, :10] = mask
    got, _ = tllm.llama_forward(to_tensors(jparams), tcfg, inputs_embeds=torch.from_numpy(embeds),
                                attention_mask=torch.from_numpy(cache_mask), kv_caches=caches)
    want, _ = jllm.llama_forward(jparams, jcfg, inputs_embeds=jnp.asarray(embeds),
                                 attention_mask=jnp.asarray(cache_mask), kv_caches=jcaches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
