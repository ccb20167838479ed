"""The ``transformer_encoder`` projection (``models/aslm.py``: the CLS-pooled
pre-LN transformer) against the JAX package's, mirroring
``tests/test_aslm.py``: the init leaf by leaf (int seed and PRNG key), the
eval forward and the projection dispatch in f32 within 1e-5 of max|ref|
(segmented unflatten, and a padded segment whose frames are all masked),
the positional-table assertion, the four dropout sites per layer, and
gradients flowing only through valid frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.ops.dropout import fold_seed
from aat_tpu_torch.utils.port import from_jax_params, port_pooling_encoder, to_tensors
from tests._torch_threads import two_threads  # noqa: F401

E, LM = 16, 24
POOL = dict(hidden_dim=32, num_heads=4, num_layers=2, ffn_dim=64, max_positions=16)
REL = 1e-5


def configs(**kw):
    """(JAX AslmConfig, port AslmConfig) of the transformer_encoder
    projection at tiny widths."""
    common = dict(projection_type="transformer_encoder", audio_encoder_hidden=E, lm_hidden=LM)
    common.update(kw)
    pool = dict(POOL, **common.pop("pooling", {}))
    return (jaslm.AslmConfig(pooling=jaslm.PoolingConfig(**pool), **common),
            taslm.AslmConfig(pooling=taslm.PoolingConfig(**pool), **common))


def assert_close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), np.abs(got - ref).max()


def test_config_dict_equals_jax():
    jcfg, tcfg = configs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(taslm.AslmConfig()) == dataclasses.asdict(jaslm.AslmConfig())


@pytest.mark.parametrize("seed", [5, "key"])
def test_init_equals_jax(seed):
    jcfg, tcfg = configs()
    if seed == "key":
        jseed = jax.random.PRNGKey(3)
        tseed = tuple(int(x) for x in np.asarray(jax.random.key_data(jseed)))
    else:
        jseed = tseed = seed
    want = jaslm.init_aslm_params(jseed, jcfg)
    got = taslm.init_aslm_params(tseed, tcfg)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda x: x.numpy(), got))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got))):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))
    layer = got["pooling"]["layers"][0]
    assert tuple(layer["attention"]["in_proj"]["kernel"].shape) == (32, 96)
    assert tuple(got["cls_token"]["embedding"].shape) == (1, E)


def frames(rng, n, t):
    x = rng.normal(0, 1.0, (n, t, E)).astype(np.float32)
    mask = np.ones((n, t), bool)
    mask[1, 5:] = False
    mask[2, :] = False  # a padded segment: every frame masked
    return x, mask


def test_pooling_forward_equals_jax():
    jcfg, tcfg = configs()
    params = jaslm.init_aslm_params(0, jcfg)
    rng = np.random.default_rng(0)
    x, mask = frames(rng, 3, 9)
    mask = np.concatenate([np.ones((3, 1), bool), mask], axis=1)  # CLS kept
    x = np.concatenate([rng.normal(0, 1, (3, 1, E)).astype(np.float32), x], axis=1)
    ref = jaslm.pooling_forward(params["pooling"], jcfg.pooling, jnp.asarray(x),
                                jnp.asarray(mask))
    got = taslm.pooling_forward(to_tensors(params["pooling"]), tcfg.pooling,
                                torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (3, 1, LM)
    assert_close(got, ref)


def test_project_and_prepare_equal_jax_segmented():
    """``prepare_audio_inputs`` with ``segments_count``: one pooled vector
    per segment, the CLS row prepended, ``out_mask = any(frame_mask)``, so
    the padded segment's audio position is masked."""
    jcfg, tcfg = configs()
    jm = jaslm.AslmModel(jcfg, jhub.tiny_test_config(), jllm.tiny_test_config())
    tm = taslm.AslmModel(tcfg, thub.tiny_test_config(), tllm.tiny_test_config())
    jcfg_lm = dataclasses.replace(jllm.tiny_test_config(), hidden_size=LM)
    tcfg_lm = dataclasses.replace(tllm.tiny_test_config(), hidden_size=LM)
    jm.lm_config, tm.lm_config = jcfg_lm, tcfg_lm
    params = {"audio_encoder": jhub.init_hubert_params(0, jhub.tiny_test_config()),
              "adapter": jaslm.init_aslm_params(1, jcfg),
              "lm_decoder": jllm.init_llama_params(2, jcfg_lm)}
    tparams = from_jax_params(params)
    rng = np.random.default_rng(1)
    x, mask = frames(rng, 4, 7)
    x, mask = x[[0, 1, 3, 2]], mask[[0, 1, 3, 2]]  # 2 rows x 2 segments; row 1's second pads
    ids = rng.integers(1, 100, (2, 4))
    text_mask = np.ones((2, 4), np.int32)
    proj_j, pmask_j = jm.project_audio_embeddings(params, jnp.asarray(x), jnp.asarray(mask))
    proj_t, pmask_t = tm.project_audio_embeddings(tparams, torch.from_numpy(x),
                                                  torch.from_numpy(mask))
    assert_close(proj_t, proj_j)
    np.testing.assert_array_equal(pmask_t.numpy(), np.asarray(pmask_j))
    assert pmask_t[:, 0].tolist() == [True, True, True, False]
    ins_j = jm.prepare_audio_inputs(params, jnp.asarray(x), jnp.asarray(mask),
                                    input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(text_mask), segments_count=2)
    ins_t = tm.prepare_audio_inputs(tparams, torch.from_numpy(x), torch.from_numpy(mask),
                                    input_ids=torch.from_numpy(ids),
                                    attention_mask=torch.from_numpy(text_mask),
                                    segments_count=2)
    assert ins_t["inputs_embeds"].shape == (2, 1 + 2 + 1 + 4, LM)
    assert_close(ins_t["inputs_embeds"], ins_j["inputs_embeds"])
    np.testing.assert_array_equal(ins_t["attention_mask"].numpy(),
                                  np.asarray(ins_j["attention_mask"]))
    assert int(ins_t["attention_mask"][1, 1 + 1]) == 0  # row 1's padded segment


def test_pooling_equals_torch_transformer_encoder():
    """The port's forward against torch ``nn.TransformerEncoder`` (pre-LN,
    batch first, key-padding mask), eval, through ``port_pooling_encoder``
    (JAX ``test_pooling_forward_parity``, 2e-4)."""
    torch.manual_seed(0)
    h, heads, layers, max_pos = 32, 4, 2, 10
    l_in, l_out = torch.nn.Linear(E, h), torch.nn.Linear(h, LM)
    pos = torch.nn.Embedding(max_pos, h)
    encoder = torch.nn.TransformerEncoder(torch.nn.TransformerEncoderLayer(
        d_model=h, nhead=heads, batch_first=True, norm_first=True), layers,
        enable_nested_tensor=False).eval()
    state = {**{f"l_in.{k}": v for k, v in l_in.state_dict().items()},
             **{f"l_out.{k}": v for k, v in l_out.state_dict().items()},
             "positional_embeddings.weight": pos.weight.detach(),
             **{f"transformer_encoder.{k}": v for k, v in encoder.state_dict().items()}}
    params = port_pooling_encoder(state)
    cfg = taslm.PoolingConfig(hidden_dim=h, num_heads=heads, num_layers=layers, ffn_dim=2048,
                              max_positions=max_pos)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1.0, (3, 8, E)).astype(np.float32))
    mask = torch.ones((3, 8), dtype=torch.int64)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    with torch.no_grad():
        hid = l_in(x) + pos.weight[:8]
        ref = l_out(encoder(hid, src_key_padding_mask=~mask.bool())[:, 0:1])
        got = taslm.pooling_forward(params, cfg, x, mask)
    assert float((got - ref).abs().max()) < 2e-4


def test_positional_table_assertion_as_jax():
    jcfg, tcfg = configs(pooling=dict(max_positions=4))
    params = jaslm.init_aslm_params(0, jcfg)
    x = np.zeros((1, 5, E), np.float32)
    mask = np.ones((1, 5), bool)
    with pytest.raises(AssertionError) as jerr:
        jaslm.pooling_forward(params["pooling"], jcfg.pooling, jnp.asarray(x), jnp.asarray(mask))
    with pytest.raises(AssertionError) as terr:
        taslm.pooling_forward(to_tensors(params["pooling"]), tcfg.pooling, torch.from_numpy(x),
                              torch.from_numpy(mask))
    assert str(terr.value) == str(jerr.value)
    assert "positional table holds 4" in str(terr.value)


def pooled(tparams, tcfg, x, mask, seed, rate, site=None, monkeypatch=None):
    """The projection's output; with ``site`` only that dropout site of each
    layer acts (the others are made the identity)."""
    if site is not None:
        real = taslm.dropout
        wanted = {fold_seed(seed, layer, site) for layer in range(tcfg.pooling.num_layers)}
        monkeypatch.setattr(taslm, "dropout",
                            lambda s, v, r, *shard: real(s, v, r, *shard) if s in wanted else v)
    cfg = dataclasses.replace(tcfg, dropout=rate)
    model = taslm.AslmModel(cfg, thub.tiny_test_config(), tllm.tiny_test_config())
    with torch.no_grad():
        out, _ = model.project_audio_embeddings(tparams, x, mask, dropout_seed=seed)
    if site is not None:
        monkeypatch.setattr(taslm, "dropout", real)
    return out


@pytest.mark.parametrize("site", [0, 1, 2, 3])
def test_each_dropout_site(monkeypatch, site):
    """Sites 0-3 of each layer (the attention probabilities, dropout1, the
    feed-forward activation, dropout2): each acts only with a seed, is
    deterministic per seed, and at rate 0 equals eval."""
    _, tcfg = configs()
    tparams = {"adapter": taslm.init_aslm_params(0, tcfg)}
    rng = np.random.default_rng(2)
    x, mask = frames(rng, 3, 9)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    run = dict(monkeypatch=monkeypatch, site=site)
    eval_out = pooled(tparams, tcfg, x, mask, None, 0.5)
    a = pooled(tparams, tcfg, x, mask, 11, 0.5, **run)
    b = pooled(tparams, tcfg, x, mask, 11, 0.5, **run)
    other = pooled(tparams, tcfg, x, mask, 12, 0.5, **run)
    assert torch.equal(a, b)
    assert not torch.equal(a, eval_out) and not torch.equal(a, other)
    assert torch.equal(pooled(tparams, tcfg, x, mask, 11, 0.0, **run), eval_out)
    calls = []
    real = taslm.dropout
    monkeypatch.setattr(taslm, "dropout",
                        lambda s, v, r, *shard: calls.append(s) or real(s, v, r, *shard))
    pooled(tparams, tcfg, x, mask, 11, 0.5)
    assert len(calls) == 4 * tcfg.pooling.num_layers and None not in calls
    assert len(set(calls)) == len(calls)


def test_gradient_flows_only_through_valid_frames():
    _, tcfg = configs()
    params = taslm.init_aslm_params(0, tcfg)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, E)).astype(np.float32)).requires_grad_(True)
    mask = torch.ones((2, 8), dtype=torch.int32)
    mask[0, 4:] = 0
    cls = params["cls_token"]["embedding"][0][None, None, :].expand(2, 1, E)
    with_cls = torch.cat([cls, x], dim=1)
    m = torch.cat([torch.ones((2, 1), dtype=torch.int32), mask], dim=1)
    out = taslm.pooling_forward(params["pooling"], tcfg.pooling, with_cls, m)
    (grad,) = torch.autograd.grad((out ** 2).sum(), x)
    assert float(grad[0, :4].abs().max()) > 0
    assert torch.equal(grad[0, 4:], torch.zeros_like(grad[0, 4:]))
    assert float(grad[1].abs().max()) > 0
