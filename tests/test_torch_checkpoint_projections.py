"""JAX orbax checkpoints of the two paths ported last, converted by
``utils/port.checkpoint_from_jax`` and resumed in the port (as
``tests/test_torch_checkpoint.py`` does for the linear projection):

- an EfficientNet-b0 run under Adafactor (relative step) with the encoder
  trained: every param and every factored statistic equal to the orbax
  state leaf for leaf, the 4-D conv kernels' ``v_row`` / ``v_col`` over
  the same named axes as JAX's (HWIO there, OIHW here);
- a ``transformer_encoder`` (pooling) run under the fused AdamW.

Then 3 more steps in each package: losses within 1e-6."""

import os

import jax
import numpy as np
import pytest
import torch
from optax._src.factorized import _factored_dims

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import efficientnet as jeff
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu.training.trainer import AATTrainerSegmentation as JTrainer
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import efficientnet as teff
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.trainer import AATTrainerSegmentation as TTrainer
from aat_tpu_torch.training.trainer import read_checkpoint_meta
from aat_tpu_torch.utils.port import checkpoint_from_jax, from_jax_params, to_jax_params
from tests.test_torch_checkpoint_optimizers import state_leaves
from tests.test_torch_training import segmented_batch
from tests.test_torch_training_projections import TRAIN, melspec_batch, two_threads  # noqa: F401


def convert(jt, tmp_path):
    """The JAX trainer's orbax checkpoint, restored to numpy and converted."""
    import orbax.checkpoint as ocp

    jpath = jt.save_checkpoint()
    template = {"params": jt.state.params, "opt_state": jt.state.opt_state,
                "step": jt.state.step}
    state = jax.device_get(ocp.StandardCheckpointer().restore(
        os.path.join(jpath, "state"), target=template))
    ppath = checkpoint_from_jax(state, str(tmp_path / "port" / f"checkpoint-{jt.state.step}"),
                                meta=read_checkpoint_meta(jpath))
    return state, ppath


def resume_both(jt, tt, make_batch, rng, steps=3):
    losses = []
    for _ in range(steps):
        batch = make_batch(rng)
        losses.append((jt.training_step([batch])["train/loss"],
                       tt.training_step([batch])["train/loss"]))
    for step, (lj, lt) in enumerate(losses):
        assert abs(lj - lt) <= 1e-6 * abs(lj), (step, lj, lt)
    return jax.device_get(jt.state.params), to_jax_params(tt.state.params)


def named_stat(jax_stat, reduced_name):
    """A JAX factored statistic of an HWIO kernel, reduced over the axis
    ``reduced_name``, in the axis order of the port's OIHW statistic."""
    jax_rest = [n for n in "HWIO" if n != reduced_name]
    port_rest = [n for n in "OIHW" if n != reduced_name]
    return np.transpose(jax_stat, [jax_rest.index(n) for n in port_rest])


@pytest.mark.slow  # about 65 s alone: JAX compiles EfficientNet-b0's backward
def test_efficientnet_adafactor_checkpoint_converts_and_resumes(tmp_path):
    aslm = dict(projection_type="mean", audio_encoder_hidden=1280, lm_hidden=32)
    jm = jaslm.AslmModel(jaslm.AslmConfig(**aslm), jeff.EfficientNetConfig(),
                         jllm.tiny_test_config(), audio_encoder_type="efficient_net")
    tm = taslm.AslmModel(taslm.AslmConfig(**aslm), teff.EfficientNetConfig(),
                         tllm.tiny_test_config(), audio_encoder_type="efficient_net")
    jp = {"audio_encoder": jeff.init_efficientnet_params(2),
          "adapter": jaslm.init_aslm_params(1, jm.config),
          "lm_decoder": jllm.init_llama_params(3, jm.lm_config)}
    cfg = dict(TRAIN, audio_encoder_type="efficient_net", optimizer="adafactor",
               learning_rate=None, gradient_accumulation_steps=1)
    jt = JTrainer(jm, jp, JConfig(**cfg, output_dir=str(tmp_path / "jax")))
    rng = np.random.default_rng(11)
    for _ in range(3):
        jt.training_step([melspec_batch(rng)], fetch_metrics=False)
    state, ppath = convert(jt, tmp_path)

    tt = TTrainer(tm, tm.init_params(7), TConfig(**cfg, output_dir=str(tmp_path / "port")))
    tt.restore_checkpoint(ppath)
    assert tt.state.step == 3
    got_params = to_jax_params(tt.state.params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(state["params"])[0],
                            jax.tree.leaves(got_params)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))
    inner = tt.state.opt_state.inner_state
    assert int(inner.count) == 3
    jleaves = state_leaves(state["opt_state"])
    compared = kernels = 0
    for name in ("v_row", "v_col", "v"):
        for path, got in state_leaves(getattr(inner, name)).items():
            want = [v for k, v in jleaves.items() if k[-len(path) - 1:] == (name,) + path]
            assert len(want) == 1, (name, path)
            want = want[0]
            if path[0] == "audio_encoder" and path[-1] == "kernel":  # an HWIO conv kernel
                # JAX's Adafactor (min_dim_size_to_factor=0)
                d1, d0 = _factored_dims(np.shape(_get(state["params"], path)), True, 0)
                want = named_stat(want, "HWIO"[d0 if name == "v_row" else d1])
                kernels += 1
            np.testing.assert_array_equal(got, want, err_msg=f"{name}{path}")
            compared += 1
    # v_row and v_col of every conv kernel: the stem, the head, and each
    # block's depthwise, squeeze-excitation pair and projection (16) and
    # expansion (15)
    assert kernels == 2 * (2 + 16 * 4 + 15) and compared > kernels
    stem = inner.v_row["audio_encoder"]["stem"]["conv"]["kernel"]
    assert tuple(stem.shape) == (3, 3, 3)  # [I, H, W]: the stem's [3, 3, 3, 32] ties 3 axes

    # the running statistics, folded into the resumed params, move on
    mean = tt.state.params["audio_encoder"]["stem"]["bn"]["mean"].clone()
    jparams, tparams = resume_both(jt, tt, melspec_batch, rng)
    assert not torch.equal(tt.state.params["audio_encoder"]["stem"]["bn"]["mean"], mean)
    # a relative step moves a BN scale by about 1e-2, and its RMS-normalized
    # 1-D update turns the rounding-level gradients a train-mode BN leaves
    # into noise of that size; read: 2e-4 at most, 4e-5 on the conv kernels
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree.leaves(tparams)):
        np.testing.assert_allclose(b, np.asarray(a), atol=2.5e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_adafactor_statistics_of_efficientnet_kernels_convert():
    """Two Adafactor updates of the EfficientNet tree by JAX's optimizer
    (HWIO) and by the port's (OIHW, the same gradients carried): the JAX
    state converted by ``checkpoint_from_jax`` equals the port's own, every
    factored statistic of the 81 conv kernels included (the stem's [3, 3,
    3, 32] ties three axes, where the port's shape alone would factor
    another pair)."""
    import tempfile

    from aat_tpu.training import optim as joptim
    from aat_tpu_torch.training import checkpoint as ckpt
    from aat_tpu_torch.training import optim as toptim
    from aat_tpu_torch.utils.port import adafactor_axes

    rng = np.random.default_rng(3)
    jtree = {"audio_encoder": jeff.init_efficientnet_params(0),
             "adapter": {"w": rng.normal(0, 1, (6, 4)).astype(np.float32)},
             "lm_decoder": {"b": rng.normal(0, 1, (5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.normal(0, 1, x.shape).astype(np.float32), jtree)
             for _ in range(2)]
    jtx = joptim.adafactor(None)
    jstate, update = jtx.init(jtree), jax.jit(jtx.update)
    for g in grads:
        _, jstate = update(g, jstate, jtree)
    tparams = from_jax_params(jtree)
    ttx = toptim.adafactor(None, axes=adafactor_axes(tparams))
    tstate = ttx.init(tparams)
    for g in grads:
        _, tstate = ttx.update(from_jax_params(g), tstate, tparams)
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint_from_jax({"params": jtree, "opt_state": jax.device_get(jstate),
                                    "step": 2}, os.path.join(tmp, "checkpoint-2"))
        got = ckpt.read_optimizer(path, "cpu")
    want = ckpt.flatten(tstate)
    assert set(got) == set(want)
    kernels = [k for k in want if k.startswith("v_row.audio_encoder") and k.endswith("kernel")]
    assert len(kernels) == 2 + 16 * 4 + 15
    assert tuple(want["v_row.audio_encoder.stem.conv.kernel"].shape) == (3, 3, 3)
    assert tuple(want["v_col.audio_encoder.stem.conv.kernel"].shape) == (32, 3, 3)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        torch.testing.assert_close(got[key], value, rtol=1e-6, atol=0, msg=key)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_pooling_checkpoint_converts_and_resumes(tmp_path):
    pool = dict(hidden_dim=32, num_heads=4, num_layers=2, ffn_dim=64, max_positions=64)
    aslm = dict(projection_type="transformer_encoder", audio_encoder_hidden=32, lm_hidden=32,
                dropout=0.0)
    jm = jaslm.AslmModel(jaslm.AslmConfig(pooling=jaslm.PoolingConfig(**pool), **aslm),
                         jhub.tiny_test_config(), jllm.tiny_test_config())
    tm = taslm.AslmModel(taslm.AslmConfig(pooling=taslm.PoolingConfig(**pool), **aslm),
                         thub.tiny_test_config(), tllm.tiny_test_config())
    jp = {"audio_encoder": jhub.init_hubert_params(0, jm.audio_encoder_config),
          "adapter": jaslm.init_aslm_params(1, jm.config),
          "lm_decoder": jllm.init_llama_params(2, jm.lm_config)}
    cfg = dict(TRAIN, gradient_accumulation_steps=1)
    jt = JTrainer(jm, jp, JConfig(**cfg, output_dir=str(tmp_path / "jax")))
    rng = np.random.default_rng(12)
    for _ in range(3):
        jt.training_step([segmented_batch(rng)], fetch_metrics=False)
    state, ppath = convert(jt, tmp_path)
    tt = TTrainer(tm, from_jax_params(jax.tree.map(np.array, jp)),
                  TConfig(**cfg, output_dir=str(tmp_path / "port")))
    tt.restore_checkpoint(ppath)
    opt, jopt = tt.state.opt_state, state["opt_state"]
    assert tt.state.step == 3 and int(opt.count) == 3
    for name, got, want in (("params", tt.state.params, state["params"]),
                            ("mu", opt.mu, jopt.mu), ("nu", opt.nu, jopt.nu)):
        flat_got = jax.tree_util.tree_flatten_with_path(to_jax_params(got))[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert ([jax.tree_util.keystr(p) for p, _ in flat_got]
                == [jax.tree_util.keystr(p) for p, _ in flat_want]), name
        for (path, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{name}{jax.tree_util.keystr(path)}")
    assert "cls_token" in state["params"]["adapter"] and opt.mu["adapter"]["cls_token"] is not None
    jparams, tparams = resume_both(jt, tt, segmented_batch, rng)
    # a step moves a parameter by about 1e-4; the bound sits far below it
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree.leaves(tparams)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
