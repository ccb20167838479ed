"""Port HuBERT encoder vs the JAX package's ``hubert_encode`` (eval mode)
at tiny widths, in the pre-LN 'large' and post-LN 'base' layouts, on the
plain attention route and on the flash route (JAX Pallas in interpret
mode, the port's kernel plain version on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt
from aat_tpu.models import hubert as jhub
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.utils.port import hubert_from_jax

LAYOUTS = {
    "large": {},  # pre-LN, layer-norm conv stack (the tiny config's defaults)
    "base": dict(feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False),
}


def configs(layout, attention_impl="xla"):
    kw = dict(LAYOUTS[layout], attention_impl=attention_impl)
    return (dataclasses.replace(jhub.tiny_test_config(), **kw),
            dataclasses.replace(thub.tiny_test_config(), **kw))


def inputs(seed, b=3, length=1600):
    rng = np.random.default_rng(seed)
    wave = rng.normal(0, 0.5, (b, length)).astype(np.float32)
    mask = np.ones((b, length), np.float32)
    mask[1, 1000:] = 0.0
    mask[2, :] = 0.0  # a padded segment: every frame masked
    return wave, mask


def encode_both(layout, attention_impl, seed):
    jcfg, tcfg = configs(layout, attention_impl)
    jparams = jhub.init_hubert_params(seed, jcfg)
    tparams = hubert_from_jax(jparams)
    wave, mask = inputs(seed)
    want, want_mask = jhub.hubert_encode(jparams, jcfg, jnp.asarray(wave), jnp.asarray(mask))
    got, got_mask = thub.hubert_encode(tparams, tcfg, torch.from_numpy(wave),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("layout", ["large", "base"])
def test_hubert_plain_route_matches_jax(layout):
    got, want = encode_both(layout, "xla", seed=0)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("layout", ["large", "base"])
def test_hubert_flash_route_matches_jax(monkeypatch, layout):
    monkeypatch.setattr(jatt, "MIN_PALLAS_SEQ_LEN", 1)
    monkeypatch.setattr(tatt, "MIN_PALLAS_SEQ_LEN", 1)
    got, want = encode_both(layout, "pallas", seed=1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_feature_lengths_match_jax():
    jcfg, tcfg = configs("large")
    lengths = np.array([0, 399, 400, 1600, 4000])
    np.testing.assert_array_equal(
        thub.feature_lengths(tcfg, torch.from_numpy(lengths)).numpy(),
        np.asarray(jhub.feature_lengths(jcfg, jnp.asarray(lengths))))


def encode_port(cfg, seed=None, layers=None):
    tparams = hubert_from_jax(jhub.init_hubert_params(4, configs("large")[0]))
    wave, mask = inputs(4)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    out, _ = thub.hubert_encode(tparams, cfg, torch.from_numpy(wave), torch.from_numpy(mask),
                                dropout_seed=seed)
    return out.numpy()


@pytest.mark.parametrize("site", ["feature_projection_dropout", "hidden_dropout",
                                  "attention_dropout", "activation_dropout"])
def test_train_mode_dropout_sites(site):
    """Each dropout site acts only with a seed, deterministically per seed
    (the masks' bits are tested against JAX in test_torch_dropout.py)."""
    cfg = dataclasses.replace(configs("large")[1], **{site: 0.5})
    eval_out = encode_port(cfg)
    a, b, c = encode_port(cfg, 3), encode_port(cfg, 3), encode_port(cfg, 4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, eval_out) and not np.array_equal(a, c)


def test_train_mode_at_zero_rates_equals_eval_and_layerdrop_skips_layers():
    cfg = configs("large")[1]
    np.testing.assert_array_equal(encode_port(cfg, 11), encode_port(cfg))
    # LayerDrop 1: every layer is skipped, as if the stack had none
    dropped = encode_port(dataclasses.replace(cfg, layerdrop=1.0), 11)
    np.testing.assert_array_equal(dropped, encode_port(cfg, layers=0))
