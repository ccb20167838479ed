"""Long-form whole-utterance training through the split flash backward:
the port's ``AATTrainer`` vs the JAX package's for 3 steps at tiny widths
with a Qwen-1.5-shaped LM (attention biases, KVH = H, θ = 1e6, untied
head), f32 compute. Both packages' gates are forced down: the flash route
from T = 1 (``MIN_PALLAS_SEQ_LEN``) and the split backward above a key
length of 16 (``_FUSED_BWD_MAX_S``), so the encoder (23 frames) and the
frozen LM (31 positions) both run JAX's ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` (Pallas in interpret mode): this test is about that
route, so its JAX reference keeps it. On the CPU the port's backward is
its plain version, which the split kernels' plain versions equal bit for
bit (test_torch_split_backward.py). Helpers and the tolerance are
``tests/_torch_trajectories.py``'s."""

import dataclasses
import itertools

import numpy as np

import jax

import aat_tpu.ops.attention as jatt
from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from test_torch_port import tiny_qwen
from test_torch_split_backward import counting
from tests._torch_trajectories import (ASLM, assert_trajectories, flash_route, run_both,
                                       whole_batch)
from tests._torch_threads import two_threads  # noqa: F401

SPLIT_ABOVE = 16


def qwen_shaped(llama_module):
    return dataclasses.replace(tiny_qwen(llama_module), attention_impl="pallas")


def test_longform_trajectory_matches_jax_through_split_backward(monkeypatch):
    calls = []
    flash_route(monkeypatch)
    monkeypatch.setattr(jatt, "MIN_PALLAS_SEQ_LEN", 1)
    monkeypatch.setattr(jatt, "_FUSED_BWD_MAX_S", SPLIT_ABOVE)
    for fn in ("_bwd_dq_kernel", "_bwd_dkv_kernel", "_bwd_fused_kernel",
               "_bwd_fused_tri_kernel"):
        monkeypatch.setattr(jatt, fn, counting(calls, fn, getattr(jatt, fn)))

    jm = jaslm.AslmModel(jaslm.AslmConfig(**ASLM),
                         dataclasses.replace(jhub.tiny_test_config(), attention_impl="pallas"),
                         qwen_shaped(jllm))
    tm = taslm.AslmModel(taslm.AslmConfig(**ASLM),
                         dataclasses.replace(thub.tiny_test_config(), attention_impl="pallas"),
                         qwen_shaped(tllm))
    rng = np.random.default_rng(11)
    lm = jllm.init_llama_params(jax.random.PRNGKey(1), jm.lm_config)
    for layer in lm["layers"]:  # non-zero attention biases, so the bias path counts
        for name in ("q", "k", "v"):
            b = layer["attention"][name]["bias"]
            layer["attention"][name]["bias"] = rng.normal(0, 0.1, b.shape).astype(np.float32)
    jp = {"audio_encoder": jhub.init_hubert_params(jax.random.PRNGKey(0), jm.audio_encoder_config),
          "adapter": jaslm.init_aslm_params(jax.random.PRNGKey(3), jm.config),
          "lm_decoder": lm}
    init_lm = jax.device_get(lm)
    # the batches continue the generator that drew the biases: the JAX
    # trainer's three, then the same three to the port's
    batches = itertools.cycle([whole_batch(rng) for _ in range(3)])
    r = run_both(lambda _: next(batches), (jm, tm), jp)
    losses, (jparams, tparams) = r.losses, r.params[-1]
    assert np.all(np.isfinite(losses))
    assert_trajectories(losses, jparams, tparams, 2e-4)
    # the JAX trainer ran its split backward and never the fused one
    assert sorted(set(calls)) == ["_bwd_dkv_kernel", "_bwd_dq_kernel"]
    # the frozen Qwen-shaped LM is bitwise its initial weights
    for a, b in zip(jax.tree.leaves(init_lm), jax.tree.leaves(tparams["lm_decoder"])):
        np.testing.assert_array_equal(b, np.asarray(a))
