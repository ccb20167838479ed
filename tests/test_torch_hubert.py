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
