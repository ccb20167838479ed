"""Parameter bridge and package hygiene: ``from_jax_params`` round-trips
(also a Qwen-shaped tree with attention biases and an untied head), the
port's int-seed and PRNG-key inits equal the bridged JAX inits, the
``build_*`` functions equal JAX's with ``pretrained=False``, and importing
the port loads no JAX."""

import dataclasses

import subprocess
import sys
import os

import numpy as np
import jax

import pytest

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import build as jbuild
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.utils.port import from_jax_params, to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_configs():
    """(JAX model, port model) at tiny widths, linear projection."""
    jcfg = jaslm.AslmConfig(projection_type="linear", audio_encoder_hidden=32,
                            lm_hidden=32, projection_hidden=48)
    tcfg = taslm.AslmConfig(projection_type="linear", audio_encoder_hidden=32,
                            lm_hidden=32, projection_hidden=48)
    jmodel = jaslm.AslmModel(jcfg, jhub.tiny_test_config(), jllm.tiny_test_config())
    tmodel = taslm.AslmModel(tcfg, thub.tiny_test_config(), tllm.tiny_test_config())
    return jmodel, tmodel


def jax_int_seed_params(jmodel, seed=0):
    """The JAX int-seed init of each part, with the seeds the port's
    ``AslmModel.init_params(seed)`` uses."""
    return {
        "audio_encoder": jhub.init_hubert_params(seed, jmodel.audio_encoder_config),
        "adapter": jaslm.init_aslm_params(seed + 1, jmodel.config),
        "lm_decoder": jllm.init_llama_params(seed + 2, jmodel.lm_config),
    }


def assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_from_jax_params_round_trips():
    jmodel, _ = tiny_configs()
    tree = jax_int_seed_params(jmodel)
    ported = from_jax_params(tree)
    # conv kernels move to PyTorch's [C_out, C_in, K]
    k0 = tree["audio_encoder"]["feature_extractor"][0]["conv"]["kernel"]
    assert tuple(ported["audio_encoder"]["feature_extractor"][0]["conv"]["kernel"].shape) == \
        k0.shape[::-1]
    assert_trees_equal(to_jax_params(ported), tree)


def test_port_int_seed_init_equals_bridged_jax_init():
    jmodel, tmodel = tiny_configs()
    want = from_jax_params(jax_int_seed_params(jmodel, seed=3))
    got = tmodel.init_params(3)
    assert_trees_equal(to_jax_params(got), to_jax_params(want))


def test_mean_projection_init_equals_jax():
    jcfg = jaslm.AslmConfig(projection_type="mean", audio_encoder_hidden=16, lm_hidden=8)
    tcfg = taslm.AslmConfig(projection_type="mean", audio_encoder_hidden=16, lm_hidden=8)
    assert_trees_equal(taslm.init_aslm_params(5, tcfg), jaslm.init_aslm_params(5, jcfg))


def tiny_qwen(llama_module):
    """A Qwen-1.5-shaped LM at tiny width: attention biases, KVH = H,
    θ = 1e6, untied head."""
    return dataclasses.replace(llama_module.tiny_test_config(), num_key_value_heads=4,
                               rope_theta=1000000.0, attention_bias=True,
                               tie_word_embeddings=False)


def test_qwen_shaped_tree_round_trips():
    jmodel, _ = tiny_configs()
    tree = jax_int_seed_params(jmodel)
    tree["lm_decoder"] = jllm.init_llama_params(jax.random.PRNGKey(1), tiny_qwen(jllm))
    attn = tree["lm_decoder"]["layers"][0]["attention"]
    assert {"q", "k", "v"} <= {n for n, p in attn.items() if "bias" in p}
    assert "lm_head" in tree["lm_decoder"]
    ported = from_jax_params(tree)
    assert_trees_equal(to_jax_params(ported), tree)


@pytest.mark.parametrize("key", [0, 1, 7])
def test_prng_key_inits_equal_jax(key):
    """A JAX key enters the host draws as its data words (0, key)."""
    jkey = jax.random.PRNGKey(key)
    words = tuple(int(x) for x in np.asarray(jax.random.key_data(jkey)))
    assert words == (0, key)
    jcfg = jaslm.AslmConfig(projection_type="linear", audio_encoder_hidden=16, lm_hidden=8,
                            projection_hidden=12)
    tcfg = taslm.AslmConfig(projection_type="linear", audio_encoder_hidden=16, lm_hidden=8,
                            projection_hidden=12)
    assert_trees_equal(taslm.init_aslm_params(words, tcfg), jaslm.init_aslm_params(jkey, jcfg))
    assert_trees_equal(tllm.init_llama_params(words, tiny_qwen(tllm)),
                       jllm.init_llama_params(jkey, tiny_qwen(jllm)))
    assert_trees_equal(thub.init_hubert_params(words, thub.tiny_test_config()),
                       from_jax_params({"audio_encoder": jhub.init_hubert_params(
                           jkey, jhub.tiny_test_config()), "adapter": {}, "lm_decoder": {}}
                       )["audio_encoder"])


def assert_same_fields(port_cfg, jax_cfg):
    """Every field of the port's config equals JAX's (JAX has more: its
    ``sp_mesh`` / ``pp_mesh`` / ``pp_microbatches`` routing fields, which the
    port keeps on the model, ``AslmModel.mesh`` and ``pp_microbatches``); a
    nested config (the ``PoolingConfig`` of ``AslmConfig``) field by field."""
    for field in dataclasses.fields(port_cfg):
        value = getattr(port_cfg, field.name)
        if dataclasses.is_dataclass(value):
            assert dataclasses.asdict(value) == dataclasses.asdict(
                getattr(jax_cfg, field.name)), field.name
        else:
            assert value == getattr(jax_cfg, field.name), field.name


@pytest.mark.parametrize("lm", ["HuggingFaceTB/SmolLM-135M-Instruct", "Qwen/Qwen1.5-1.8B"])
def test_build_model_equals_jax(monkeypatch, lm):
    """``build_model(pretrained=False)`` in both packages, with the full-size
    configs swapped for tiny ones: the same configs and the same draws."""
    monkeypatch.setattr(jhub, "hubert_large_config", jhub.tiny_test_config)
    monkeypatch.setattr(thub, "hubert_large_config", thub.tiny_test_config)
    monkeypatch.setattr(jllm, "smollm_135m_config", jllm.tiny_test_config)
    monkeypatch.setattr(tllm, "smollm_135m_config", tllm.tiny_test_config)
    monkeypatch.setattr(jllm, "qwen15_18b_config", lambda: tiny_qwen(jllm))
    monkeypatch.setattr(tllm, "qwen15_18b_config", lambda: tiny_qwen(tllm))
    jmodel, jparams = jbuild.build_model(JConfig(lm_pretrained_model=lm), pretrained=False,
                                         seed=3)
    tmodel, tparams = tbuild.build_model(TConfig(lm_pretrained_model=lm), pretrained=False,
                                         seed=3, device="cpu")
    assert_same_fields(tmodel.lm_config, jmodel.lm_config)
    assert_same_fields(tmodel.audio_encoder_config, jmodel.audio_encoder_config)
    assert_same_fields(tmodel.config, jmodel.config)
    assert_trees_equal(to_jax_params(tparams), jax.device_get(jparams))


def test_build_refuses_pretrained_and_full_configs_match_jax():
    """``pretrained=True`` with a hub name and no local directory is refused
    (nothing is downloaded; reading a local directory is held against JAX
    in ``tests/test_torch_hf_readers.py``)."""
    for build in (tbuild.build_audio_encoder, tbuild.build_lm_decoder):
        with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
            build(TConfig(), pretrained=True, device="cpu")
    assert_same_fields(tllm.qwen15_18b_config(), jllm.qwen15_18b_config())
    # the decoder's remat fields, in both packages
    for cfg in (tllm.qwen15_18b_config(), tllm.smollm_135m_config(), tllm.tiny_test_config()):
        assert (cfg.remat, cfg.remat_policy) == (False, "full")
    remat = dataclasses.replace(tllm.tiny_test_config(), remat=True, remat_policy="dots")
    assert_same_fields(remat, dataclasses.replace(jllm.tiny_test_config(), remat=True,
                                                  remat_policy="dots"))
    assert {f.name for f in dataclasses.fields(tllm.LlamaConfig)} == {
        f.name for f in dataclasses.fields(jllm.LlamaConfig)} - {"pp_mesh", "pp_microbatches"}
    q = tllm.qwen15_18b_config()
    assert (q.hidden_size // q.num_attention_heads, q.num_key_value_heads) == (128, 16)


def test_port_imports_no_jax():
    modules = [
        "aat_tpu_torch", "aat_tpu_torch.ops.mel", "aat_tpu_torch.ops.segmentation",
        "aat_tpu_torch.ops.ragged", "aat_tpu_torch.ops.attention",
        "aat_tpu_torch.data.ondevice", "aat_tpu_torch.models.hubert",
        "aat_tpu_torch.models.llama", "aat_tpu_torch.models.aslm",
        "aat_tpu_torch.serving.engine", "aat_tpu_torch.serving.serve",
        "aat_tpu_torch.utils.port", "aat_tpu_torch.runtime.kernels",
        "aat_tpu_torch.ops.dropout", "aat_tpu_torch.training.config",
        "aat_tpu_torch.training.lr_schedule", "aat_tpu_torch.training.optim",
        "aat_tpu_torch.training.trainer", "aat_tpu_torch.training.checkpoint",
        "aat_tpu_torch.training.generate", "aat_tpu_torch.training.metrics",
        "aat_tpu_torch.audio", "aat_tpu_torch.tokenizer",
        "aat_tpu_torch.runtime.host_ops", "aat_tpu_torch.ops.vq", "aat_tpu_torch.models.build",
        "aat_tpu_torch.runtime.device",
        "aat_tpu_torch.scripts", "aat_tpu_torch.scripts.segment_embeddings",
        "aat_tpu_torch.scripts.mean_segment_embeddings",
        "aat_tpu_torch.scripts.quantize_embeddings",
        "aat_tpu_torch.data.collate", "aat_tpu_torch.data.dataloaders",
        "aat_tpu_torch.data.datasets", "aat_tpu_torch.utils.tracking",
        "aat_tpu_torch.utils.timing", "aat_tpu_torch.scripts.train",
        "aat_tpu_torch.scripts.validate", "aat_tpu_torch.scripts.serve",
        "aat_tpu_torch.runtime.native", "aat_tpu_torch.utils.flops",
        "aat_tpu_torch.scripts.melspec_precompute", "aat_tpu_torch.scripts.audio_tokenization",
        "aat_tpu_torch.scripts.reduce_seq_len", "aat_tpu_torch.scripts.merge_datasets",
        "aat_tpu_torch.scripts.dataset_info", "aat_tpu_torch.scripts.inspect_embeddings",
        "aat_tpu_torch.scripts.parity_check", "aat_tpu_torch.parallel",
        "aat_tpu_torch.parallel.distributed", "aat_tpu_torch.parallel.mesh",
        "aat_tpu_torch.parallel.sequence", "aat_tpu_torch.parallel.comm",
        "aat_tpu_torch.models.efficientnet", "aat_tpu_torch.parallel.pipeline",
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aat_tpu', "
        "'orbax', 'transformers', 'safetensors', 'nltk', 'datasets', 'regex', 'wandb'))\n"
        + "built = (aat_tpu_torch.runtime.kernels._library is not None\n"
        + "         or aat_tpu_torch.runtime.native._tried)\n"
        + "print(bad, 'kernel library built' if built else '')\n"
        + "sys.exit(1 if bad or built else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
