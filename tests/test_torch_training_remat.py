"""Encoder remat (``HubertConfig.remat``, from ``encoder_remat`` through
``models/build``): with either policy the encoder's value and every
parameter gradient equal no remat's bit for bit on the CPU (dropout and
LayerDrop on: the seeded masks are redrawn exactly in the recompute), each
layer's forward runs again in the backward and not without autograd,
``"dots"`` re-runs no product without batch dimensions (``mm``/``addmm``)
and every layer's attention ``bmm`` (JAX's
``dots_with_no_batch_dims_saveable``), and 3 trainer steps with either
policy match JAX's remat trainer within the trajectory tolerance
(``tests/test_training.py:265``)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import aat_tpu_torch.ops.attention as tatt
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.training import optim as toptim
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from tests._torch_trajectories import (assert_trajectories, flash_route, models, run_both,
                                       whole_batch)
from tests._torch_threads import two_threads  # noqa: F401
from tests.test_torch_training_optimizers import TOL

DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
               layerdrop=0.3)


def encode_with_grads(cfg, params, seed=7):
    leaves = []

    def leaf(x):
        x = x.detach().clone().requires_grad_(True)
        leaves.append(x)
        return x

    p = toptim.tree_map(leaf, params)
    wav = torch.from_numpy(np.random.default_rng(0).normal(0, 0.5, (2, 1200)).astype(np.float32))
    mask = torch.ones((2, 1200), dtype=torch.int32)
    mask[1, 1000:] = 0
    out, _ = thub.hubert_encode(p, cfg, wav, mask, dropout_seed=seed)
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves, allow_unused=True)
    return out.detach(), grads


def tiny(**kw):
    return dataclasses.replace(thub.tiny_test_config(), attention_impl="pallas", **DROPOUT, **kw)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_value_and_gradients_equal_no_remat(monkeypatch, policy):
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    params = thub.init_hubert_params(0, tiny())
    for seed in (7, 8):  # LayerDrop skips other layers under another seed
        out, grads = encode_with_grads(tiny(), params, seed)
        out_r, grads_r = encode_with_grads(tiny(remat=True, remat_policy=policy), params, seed)
        assert torch.equal(out, out_r)
        assert len(grads) == len(grads_r)
        for g, g_r in zip(grads, grads_r):
            assert (g is None and g_r is None) or torch.equal(g, g_r)
        assert any(g is not None and float(g.abs().max()) > 0 for g in grads_r)


class CountOps(TorchDispatchMode):
    def __init__(self, names):
        super().__init__()
        self.count = dict.fromkeys(names, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.count:
            self.count[name] += 1
        return func(*args, **(kwargs or {}))


def backward_products(cfg, wav):
    """The matrix products run in the backward of one encoder forward, by
    op: ``{"mm": n, "addmm": n, "bmm": n}``."""
    params = thub.init_hubert_params(0, cfg)
    leaves = toptim.tree_map(lambda x: x.detach().requires_grad_(True), params)
    out, _ = thub.hubert_encode(leaves, cfg, wav)
    mms = CountOps(("mm", "addmm", "bmm"))
    with mms:
        out.sum().backward()
    return mms.count


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recomputes_layers_in_the_backward_only(monkeypatch, policy):
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    calls = {"n": 0}
    attention = thub.attention_bthd

    def counted(*args, **kw):
        calls["n"] += 1
        return attention(*args, **kw)

    monkeypatch.setattr(thub, "attention_bthd", counted)
    plain = dataclasses.replace(thub.tiny_test_config(), attention_impl="pallas")
    cfg = dataclasses.replace(plain, remat=True, remat_policy=policy)
    wav = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (2, 1200)).astype(np.float32))
    with torch.no_grad():
        thub.hubert_encode(thub.init_hubert_params(0, cfg), cfg, wav)
    assert calls["n"] == cfg.num_hidden_layers  # no autograd: one forward
    calls["n"] = 0
    products = backward_products(cfg, wav)
    assert calls["n"] == 2 * cfg.num_hidden_layers  # the recompute
    calls["n"] = 0
    plain_products = backward_products(plain, wav)
    assert calls["n"] == cfg.num_hidden_layers
    # "dots" keeps the products without batch dimensions (the projections
    # and the feed-forward: mm/addmm) and recomputes each layer's two
    # attention bmms (QK^T, P.V); "full" re-runs both kinds
    dense = ("mm", "addmm")
    if policy == "dots":
        assert all(products[op] == plain_products[op] for op in dense)
        assert products["bmm"] == plain_products["bmm"] + 2 * cfg.num_hidden_layers
    else:
        assert sum(products[op] for op in dense) > sum(plain_products[op] for op in dense)
        assert products["bmm"] == plain_products["bmm"] + 2 * cfg.num_hidden_layers


def test_build_applies_remat(monkeypatch):
    """``encoder_remat`` / ``encoder_remat_policy`` land on the built
    ``HubertConfig`` (JAX ``tests/test_training.py`` ``apply_remat``)."""
    monkeypatch.setattr(tbuild.hub, "hubert_large_config", thub.tiny_test_config)
    _, cfg = tbuild.build_audio_encoder(TConfig(encoder_remat=True, encoder_remat_policy="dots"),
                                        pretrained=False, device="cpu")
    assert cfg.remat and cfg.remat_policy == "dots"
    _, cfg = tbuild.build_audio_encoder(TConfig(), pretrained=False, device="cpu")
    assert not cfg.remat


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_trajectory_matches_jax(monkeypatch, policy):
    flash_route(monkeypatch)
    r = run_both(whole_batch, models(remat=True, remat_policy=policy), seed=7)
    assert r.tt.model.audio_encoder_config.remat and r.reference.model.audio_encoder_config.remat
    assert_trajectories(r.losses, *r.params[-1], TOL)
