"""The port's HF checkpoint readers (``aat_tpu_torch/utils/port.py``,
``models/build.py`` with ``pretrained=True``) against the JAX package's,
which read the same directories through ``transformers``: tiny random
``HubertModel``, ``HubertForCTC``, ``Wav2Vec2Model`` and
``LlamaForCausalLM`` (tied and untied, GQA) saved with ``save_pretrained``
as safetensors, ``.bin``, sharded, in bf16, with the older ``weight_g`` /
``weight_v`` names, and a Qwen2-style directory whose q/k/v biases
``LlamaForCausalLM`` drops. Every tensor equals ``from_jax_params`` of
JAX's tree (the weight-normed positional conv within 1e-6: the two fold
g · v / ||v|| in another order), the configs equal JAX's field by field
(also from a ``config.json`` stripped of the keys that equal the
``transformers`` class defaults), and a forward of the read weights is
within 2e-4 of the HF module's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import transformers

import jax

from aat_tpu.models import build as jbuild
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu.utils.port import port_pooling_encoder as jport_pooling
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.runtime.device import resolve_device
from aat_tpu_torch.training.checkpoint import flatten
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.utils import port as tport
from aat_tpu_torch.utils.port import hubert_from_jax, to_tensors
from tests.test_aslm import TorchPoolingOracle

# full-precision torch kernels for the HF oracle (this host's oneDNN build
# runs conv and matmul in bf16 fastmath otherwise)
torch.backends.mkldnn.enabled = False

POS_CONV_TOL = 1e-6
FORWARD_TOL = 2e-4
HUBERT = dict(vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
              conv_kernel=(10, 3, 3), num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, mask_time_prob=0.0)
LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def hubert_model(kind="HubertModel", stable=True, norm="layer", bias=True, dropout=0.0):
    config_cls = transformers.Wav2Vec2Config if kind.startswith("Wav2Vec2") else \
        transformers.HubertConfig
    cfg = config_cls(**HUBERT, do_stable_layer_norm=stable, feat_extract_norm=norm,
                     conv_bias=bias, hidden_dropout=dropout, attention_dropout=dropout,
                     activation_dropout=dropout, feat_proj_dropout=dropout, layerdrop=dropout)
    torch.manual_seed(0)
    return getattr(transformers, kind)(cfg).eval()


def llama_model(tied=False, kind="LlamaForCausalLM"):
    cfg_cls = transformers.Qwen2Config if kind.startswith("Qwen2") else transformers.LlamaConfig
    cfg = cfg_cls(**LLAMA, tie_word_embeddings=tied, attn_implementation="eager")
    torch.manual_seed(1)
    return getattr(transformers, kind)(cfg).eval()


def save(model, path, form):
    """``model`` saved under ``path`` in one of the file forms."""
    if form == "bf16":
        model = model.to(torch.bfloat16)
    kw = {"bin": dict(safe_serialization=False), "sharded": dict(max_shard_size="20KB"),
          "sharded_bin": dict(max_shard_size="20KB", safe_serialization=False)}.get(form, {})
    model.save_pretrained(str(path), **kw)
    return str(path)


def with_weight_g_v(path):
    """Rewrite a ``.bin`` checkpoint with the positional conv's older names
    (``weight_g`` / ``weight_v``, as hubert-large-ls960-ft stores it)."""
    file = os.path.join(path, "pytorch_model.bin")
    state = torch.load(file, weights_only=True)
    renamed = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
               for k, v in state.items()}
    assert any(k.endswith("weight_g") for k in renamed)
    torch.save(renamed, file)
    return path


def assert_same_fields(port_cfg, jax_cfg, skip=()):
    for field in dataclasses.fields(port_cfg):
        if field.name not in skip:
            assert getattr(port_cfg, field.name) == getattr(jax_cfg, field.name), field.name


def assert_trees(got, want, inexact=()):
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        if k in inexact:
            torch.testing.assert_close(got[k], w, atol=POS_CONV_TOL, rtol=0, msg=k)
        else:
            assert torch.equal(got[k], w), k


HUBERT_CASES = {
    "HubertModel-safetensors": ("HubertModel", "safetensors", dict()),
    "HubertForCTC-group-norm": ("HubertForCTC", "safetensors",
                                dict(stable=False, norm="group", bias=False)),
    "Wav2Vec2Model-bin": ("Wav2Vec2Model", "bin", dict()),
    "Wav2Vec2ForCTC-sharded": ("Wav2Vec2ForCTC", "sharded", dict()),
    "HubertForCTC-weight_g_v": ("HubertForCTC", "bin", dict()),
    "HubertModel-bf16": ("HubertModel", "bf16", dict(dropout=0.1)),
}


@pytest.mark.parametrize("case", sorted(HUBERT_CASES))
def test_hubert_reader_equals_jax(tmp_path, case):
    kind, form, kw = HUBERT_CASES[case]
    model = hubert_model(kind, **kw)
    path = save(model, tmp_path / "enc", form)
    if case.endswith("weight_g_v"):
        with_weight_g_v(path)
    enc_type = "wav2vec2" if kind.startswith("Wav2Vec2") else "hubert"
    jparams, jcfg = jbuild.build_audio_encoder(
        JConfig(audio_encoder_type=enc_type, audio_encoder_checkpoint=path), pretrained=True)
    tparams, tcfg = tbuild.build_audio_encoder(
        TConfig(audio_encoder_type=enc_type, audio_encoder_checkpoint=path), pretrained=True,
        device="cpu")
    assert_trees(tparams, hubert_from_jax(jax.device_get(jparams)), inexact=("pos_conv.kernel",))
    # build_audio_encoder asks for the flash route; the reader's config is JAX's
    assert tcfg.attention_impl == "pallas"
    assert_same_fields(tcfg, jcfg, skip=("attention_impl",))
    assert_same_fields(tport.port_hubert(path, enc_type)[1], jcfg)

    if form == "bf16":
        return  # the HF module itself runs in bf16
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.5, (2, 2000)).astype(np.float32)
    mask = np.ones((2, 2000), np.int64)
    mask[1, 1200:] = 0
    base = getattr(model, model.base_model_prefix, model)
    with torch.no_grad():
        want = base(input_values=torch.from_numpy(wav),
                    attention_mask=torch.from_numpy(mask)).last_hidden_state
        got, frame_mask = thub.hubert_encode(tparams, tport.port_hubert(path, enc_type)[1],
                                             torch.from_numpy(wav), torch.from_numpy(mask))
    assert float((got - want).abs()[frame_mask].max()) < FORWARD_TOL


def test_weight_normed_conv_is_g_v_over_norm(tmp_path):
    """Both stored forms of the positional conv give g · v / ||v||, the
    norm over dims 0 and 1 for each tap, computed here in float64."""
    path = with_weight_g_v(save(hubert_model("HubertModel"), tmp_path / "enc", "bin"))
    _, state = tport.read_hf_checkpoint(path)
    g = state["encoder.pos_conv_embed.conv.weight_g"].double()
    v = state["encoder.pos_conv_embed.conv.weight_v"].double()
    assert g.shape == (1, 1, HUBERT["num_conv_pos_embeddings"])
    want = g * v / v.norm(dim=(0, 1), keepdim=True)
    got = tport.port_hubert(path)[0]["pos_conv"]["kernel"]
    torch.testing.assert_close(got.double(), want, atol=POS_CONV_TOL, rtol=0)


LLAMA_CASES = {
    "tied-safetensors": (True, "LlamaForCausalLM", "safetensors"),
    "untied-bin": (False, "LlamaForCausalLM", "bin"),
    "untied-sharded": (False, "LlamaForCausalLM", "sharded"),
    "tied-sharded-bin": (True, "LlamaForCausalLM", "sharded_bin"),
    "untied-bf16": (False, "LlamaForCausalLM", "bf16"),
    "qwen2-biases-dropped": (False, "Qwen2ForCausalLM", "safetensors"),
}


@pytest.mark.parametrize("case", sorted(LLAMA_CASES))
def test_llama_reader_equals_jax(tmp_path, case):
    tied, kind, form = LLAMA_CASES[case]
    model = llama_model(tied, kind)
    path = save(model, tmp_path / "lm", form)
    _, state = tport.read_hf_checkpoint(path)
    if kind.startswith("Qwen2"):
        assert "model.layers.0.self_attn.q_proj.bias" in state  # in the file, not read
    if form == "bf16":
        assert state["model.embed_tokens.weight"].dtype == torch.bfloat16
    jparams, jcfg = jbuild.build_lm_decoder(JConfig(lm_pretrained_model=path), pretrained=True)
    tparams, tcfg = tbuild.build_lm_decoder(TConfig(lm_pretrained_model=path), pretrained=True,
                                            device="cpu")
    assert_trees(tparams, to_tensors(jax.device_get(jparams)))
    assert tcfg.attention_impl == "pallas" and not tcfg.attention_bias
    assert_same_fields(tcfg, jcfg, skip=("attention_impl",))
    assert ("lm_head" in tparams) == (not tied)

    if form == "bf16" or kind.startswith("Qwen2"):
        return  # bf16 module; a Qwen2 module keeps the biases the Llama read drops
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (2, 9)))
    with torch.no_grad():
        want = model(input_ids=ids).logits
        got, _ = tllm.llama_forward(tparams, tport.port_llama(path)[1], input_ids=ids)
    assert float((got - want).abs().max()) < FORWARD_TOL


def stripped(config: dict, defaults: dict) -> dict:
    """A ``config.json`` dict without the keys equal to the class defaults."""
    return {k: v for k, v in config.items()
            if not (k in defaults and (list(v) if isinstance(v, (list, tuple)) else v)
                    == (list(defaults[k]) if isinstance(defaults[k], (list, tuple))
                        else defaults[k]))}


@pytest.mark.parametrize("kind", ["HubertModel", "Wav2Vec2Model", "LlamaForCausalLM"])
def test_configs_from_stripped_config_json(tmp_path, kind):
    """A ``config.json`` that leaves out every key at its class default
    reads as ``transformers`` reads it (the JAX reader's config)."""
    from aat_tpu.utils.port import hubert_config_from_torch, llama_config_from_torch

    if kind == "LlamaForCausalLM":
        model = llama_model()
        hf_cls, read, jread = transformers.LlamaConfig, tport.llama_config_from_hf, \
            llama_config_from_torch
    else:
        model = hubert_model(kind, stable=False, norm="group", bias=False, dropout=0.1)
        hf_cls = transformers.Wav2Vec2Config if kind.startswith("Wav2Vec2") else \
            transformers.HubertConfig
        read, jread = tport.hubert_config_from_hf, hubert_config_from_torch
    full = model.config.to_dict()
    defaults = hf_cls().to_dict()
    small = stripped(full, defaults)
    assert len(small) < len(full)
    for key in ("conv_bias", "feat_extract_norm", "do_stable_layer_norm", "rms_norm_eps",
                "rope_theta", "tie_word_embeddings", "attention_bias", "layerdrop"):
        assert key not in small  # each at its default, so left out
    (tmp_path / "config.json").write_text(json.dumps(small))
    hf = hf_cls.from_pretrained(str(tmp_path))
    assert_same_fields(read(small), jread(hf))
    assert_same_fields(read(full), jread(model.config))


def test_pooling_encoder_reader_equals_jax():
    torch.manual_seed(0)
    oracle = TorchPoolingOracle().eval()
    want = jport_pooling(oracle)
    state = {f"projection.{k}": v for k, v in oracle.state_dict().items()}
    got = tport.port_pooling_encoder(state, prefix="projection.")
    assert len(got["layers"]) == 2
    assert_trees(got, to_tensors(want))


def test_safetensors_parser_reads_what_safetensors_writes(tmp_path):
    from safetensors.torch import save_file

    tensors = {"a": torch.randn(3, 5), "b": torch.randn(7).to(torch.bfloat16),
               "c": torch.randn(2, 2).to(torch.float16)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = tport.read_safetensors(str(tmp_path / "x.safetensors"))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        got[k].add_(1)  # writable: each tensor owns its memory
    save_file({"i": torch.arange(6)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="tensor i has dtype I64"):
        tport.read_safetensors(str(tmp_path / "i.safetensors"))


def test_missing_key_names_it(tmp_path):
    path = save(llama_model(), tmp_path / "lm", "safetensors")
    config, state = tport.read_hf_checkpoint(path)
    del state["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        tport.port_llama((config, state))


def test_hub_name_without_local_copy_raises_before_the_device(monkeypatch):
    """No download: a hub name with no local directory raises, naming the
    need for a local checkpoint directory, before the device is resolved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tbuild.build_audio_encoder, tbuild.build_lm_decoder):
        with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
            build(TConfig(), pretrained=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
