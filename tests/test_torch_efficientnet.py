"""EfficientNet-b0 (``models/efficientnet.py``) against the JAX package's,
mirroring ``tests/test_efficientnet.py`` and ``tests/test_port_efficientnet.py``:
the init (HWIO → OIHW), TF-SAME padding at stride 2, the features (and the
batch statistics they reach) in eval and train mode at melspec shape [4,
64, 26] within 1e-4 of max|ref|, the statistics of one activation within
1e-6 relative of the exact ones, ``apply_bn_updates``, the lukemelas
port (module and state dict) and its forward against the torch twin, and
the ``pretrained=True`` fallback."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aat_tpu.models import efficientnet as jeff
from aat_tpu_torch.models import efficientnet as teff
from aat_tpu_torch.utils.port import encoder_from_jax, from_jax_params, to_jax_params
from tests.test_port_efficientnet import build_fake_b0, torch_b0_features
from tests._torch_threads import two_threads  # noqa: F401


@pytest.fixture(scope="module")
def jparams():
    return jeff.init_efficientnet_params(seed=0)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_init_equals_jax_in_torch_layout(jparams):
    got = teff.init_efficientnet_params(0)
    want = encoder_from_jax(jparams)
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == jax.tree.structure(
        jax.tree.map(lambda x: x.numpy(), got))
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got)),
                    jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), want))):
        np.testing.assert_array_equal(a, b)
    # OIHW, depthwise [mid, 1, k, k]; HWIO k x k x cin x cout in JAX
    assert tuple(got["stem"]["conv"]["kernel"].shape) == (32, 3, 3, 3)
    assert tuple(got["blocks"][1]["dw_conv"]["kernel"].shape) == (96, 1, 3, 3)
    np.testing.assert_array_equal(got["stem"]["conv"]["kernel"].numpy(),
                                  jparams["stem"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    tree = {"audio_encoder": jparams, "adapter": {}, "lm_decoder": {}}
    back = to_jax_params(from_jax_params(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [64, 13, 7])
@pytest.mark.parametrize("k", [3, 5])
def test_tf_same_padding_at_stride_2(size, k):
    """The port's F.pad + conv equals JAX's ``padding="SAME"`` (asymmetric
    at stride 2: the odd pixel goes high)."""
    rng = np.random.default_rng(size + k)
    x = rng.normal(0, 1, (2, size, size + 3, 4)).astype(np.float32)  # NHWC
    kernel = rng.normal(0, 0.3, (k, k, 4, 6)).astype(np.float32)  # HWIO
    ref = np.asarray(jeff._conv2d(jnp.asarray(x), kernel, stride=2))
    got = teff._conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(kernel).permute(3, 2, 0, 1), stride=2)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, -(-size // 2), -(-(size + 3) // 2), 6)
    assert rel_err(got, ref) <= 1e-5
    total = max((-(-size // 2) - 1) * 2 + k - size, 0)
    assert teff.same_padding(size, k, 2) == (total // 2, total - total // 2)
    if size == 64 and k == 3:
        assert teff.same_padding(64, 3, 2) == (0, 1)


def mels(seed, shape=(4, 64, 26)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def test_features_equal_jax_eval_and_train(jparams):
    tparams = encoder_from_jax(jparams)
    x = mels(1)
    jad, tad = jeff.EfficientNetAudioEncoderAdapter(), teff.EfficientNetAudioEncoderAdapter()
    ref = np.asarray(jad(jparams, jnp.asarray(x)))
    got = tad(tparams, torch.from_numpy(x))
    assert got.shape == (4, 1, 1280)
    assert rel_err(got, ref) <= 1e-4
    # a [bs, 1, n_mels, T] input gives the same
    assert torch.equal(tad(tparams, torch.from_numpy(x[:, None])), got)

    ref, jstats = jad(jparams, jnp.asarray(x), train=True)
    got, tstats = tad(tparams, torch.from_numpy(x), train=True)
    assert rel_err(got, ref) <= 1e-4
    flat_j = jax.tree_util.tree_flatten_with_path(jax.device_get(jstats))[0]
    flat_t = jax.tree.leaves(jax.tree.map(lambda v: v.numpy(), tstats))
    assert len(flat_j) == len(flat_t) == 2 * (2 + sum(
        3 if s["expand"] != 1 else 2 for s in teff.block_specs()))
    # the statistics the network reaches inherit the forward's tolerance
    # (test_batch_stats_equal_jax holds their computation to 1e-6), each
    # on the scale of its activation: a mean against the largest standard
    # deviation (a mean after a BN is ~1e-8), a variance against itself
    for (path, a), b in zip(flat_j, flat_t):
        assert b.dtype == np.float32
        key = jax.tree_util.keystr(path)
        var_key = key[:key.rindex("[")] + "['var']"
        var = dict((jax.tree_util.keystr(p), v) for p, v in flat_j)[var_key]
        scale = np.sqrt(np.abs(var).max()) if key.endswith("['mean']") else np.abs(a).max()
        assert np.abs(b - a).max() <= 1e-4 * scale, key
    assert all(not v.requires_grad for v in jax.tree.leaves(tstats))


@pytest.mark.parametrize("shape", [(4, 32, 13, 24), (2, 16, 6, 320)])
def test_batch_stats_equal_jax(shape):
    """The BN statistics of one activation (the f32 mean and unbiased
    variance, and the biased pair that normalizes) within 1e-6 relative of
    the exact (float64) statistics. JAX's f32 reduction sums in another
    order and is itself up to about 1.5e-6 off them, so the port's
    difference from JAX is held to JAX's own error plus 1e-6."""
    x = np.random.default_rng(6).normal(0.3, 2.0, shape).astype(np.float32)  # NHWC
    x64, n = x.astype(np.float64), x[..., 0].size
    mean64 = x64.mean((0, 1, 2))
    var64 = np.square(x64 - mean64).mean((0, 1, 2))
    exact = (mean64, var64, mean64, var64 * n / (n - 1))
    want = jeff._batch_stats(jnp.asarray(x))
    got = teff._batch_stats(torch.from_numpy(x).permute(0, 3, 1, 2))
    for a, b, e in zip(want, got, exact):
        assert b.dtype == torch.float32 and b.shape == (shape[-1],)
        assert rel_err(b, e) <= 1e-6
        assert rel_err(b, a) <= rel_err(a, e) + 1e-6
    assert rel_err(got[3], got[1] * (n / (n - 1))) == 0.0


def test_bn_train_mode_matches_torch():
    """The port's train-mode BN against ``nn.BatchNorm2d``: the batch's
    biased statistics normalize, the unbiased variance feeds the EMA
    (JAX ``test_bn_train_mode_matches_torch``)."""
    c = 8
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 2, (3, c, 5, 7)).astype(np.float32))
    p = {"scale": torch.from_numpy(rng.normal(1, 0.1, c).astype(np.float32)),
         "bias": torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
         "mean": torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)),
         "var": torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))}
    tbn = torch.nn.BatchNorm2d(c, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(tbn, name).copy_(p[key])
        ref = tbn(x)
    mean, var, mean32, unbiased = teff._batch_stats(x)
    assert float((teff._bn(x, p, (mean, var)) - ref).abs().max()) < 2e-5
    merged = teff.apply_bn_updates({"stem": {"bn": p}, "blocks": [], "head": {}},
                                   {"stem": {"bn": {"mean": mean32, "var": unbiased}},
                                    "blocks": [], "head": {}})
    assert float((merged["stem"]["bn"]["mean"] - tbn.running_mean).abs().max()) < 1e-6
    assert float((merged["stem"]["bn"]["var"] - tbn.running_var).abs().max()) < 1e-5
    assert merged["stem"]["bn"]["scale"] is p["scale"]


def test_apply_bn_updates_equals_jax(jparams):
    _, jstats = jeff.efficientnet_features(jparams, jnp.asarray(
        mels(3, (2, 64, 26, 1)).repeat(3, axis=-1)), train=True)
    jstats = jax.device_get(jstats)
    want = jax.device_get(jeff.apply_bn_updates(jparams, jstats))
    tstats = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jstats)
    got = teff.apply_bn_updates(encoder_from_jax(jparams), tstats)
    tree = to_jax_params({"audio_encoder": got, "adapter": {}, "lm_decoder": {}})
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(tree["audio_encoder"])):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def fake_state_dict(net):
    """The lukemelas module's ``state_dict()`` keys, from the fake."""
    state = {}

    def add(prefix, module):
        state.update({f"{prefix}.{k}": v for k, v in module.state_dict().items()})

    for name in ("_conv_stem", "_bn0", "_conv_head", "_bn1"):
        add(name, getattr(net, name))
    for i, block in enumerate(net._blocks):
        for name, module in vars(block).items():
            add(f"_blocks.{i}.{name}", module)
    return state


@pytest.mark.parametrize("source", ["module", "state_dict"])
def test_port_efficientnet_maps_every_key(source):
    net = build_fake_b0()
    got = teff.port_efficientnet(net if source == "module" else fake_state_dict(net))
    want = encoder_from_jax(jeff.port_efficientnet(net))
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: x.numpy(), want))[0]
    flat_g = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: x.numpy(), got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == \
        [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    init = teff.init_efficientnet_params(0)
    assert float((got["stem"]["conv"]["kernel"] - init["stem"]["conv"]["kernel"]).abs().max()) \
        > 1e-3
    state = fake_state_dict(net)
    del state["_blocks.3._se_reduce.bias"]
    with pytest.raises(KeyError, match="_blocks.3._se_reduce.bias"):
        teff.port_efficientnet(state)


def test_ported_forward_matches_torch_twin():
    net = build_fake_b0(seed=1)
    params = teff.port_efficientnet(net)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (2, 3, 64, 32))
                         .astype(np.float32))
    with torch.no_grad():
        ref = torch_b0_features(net, x)
    got = teff.efficientnet_features(params, x)
    assert float((got - ref).abs().max()) <= max(2e-4, 1e-4 * float(ref.abs().max()))


def test_pretrained_without_package_warns_and_uses_seeded_init(caplog):
    with caplog.at_level(logging.WARNING, logger="aat_tpu_torch.models.efficientnet"):
        params, cfg = teff.build_efficientnet_encoder(pretrained=True, device="cpu")
    assert "efficientnet_pytorch unavailable" in caplog.text
    assert cfg == teff.EfficientNetConfig()
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), params)),
                    jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                 teff.init_efficientnet_params(0)))):
        np.testing.assert_array_equal(a, b)
