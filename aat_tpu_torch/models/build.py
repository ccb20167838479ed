"""Model construction (counterpart of ``aat_tpu/models/build.py``): the
audio encoder (HuBERT, wav2vec2 or EfficientNet-b0) and the Llama-family
LM decoder that a
:class:`~aat_tpu_torch.training.config.TrainingConfig` names, the
tokenizer, the composed ASLM, and :func:`load_pretrained` of an export.

``pretrained=True`` reads the HF checkpoints that ``audio_encoder_checkpoint``
and ``lm_pretrained_model`` name from local directories
(:mod:`aat_tpu_torch.utils.port`: ``config.json`` with ``model.safetensors``,
its sharded index or ``pytorch_model.bin``); a hub name with no local
directory raises ``FileNotFoundError``, as nothing is downloaded. Read
weights take the flash route (``attention_impl="pallas"``), as the
full-size presets do; the JAX package's pretrained configs keep its plain
route, which computes the same function. ``pretrained=False`` draws random
weights as the JAX package draws them (``PRNGKey(0)`` for the encoder,
``PRNGKey(1)`` for the decoder, ``PRNGKey(seed)`` for the adapter). An
adapter exported by ``AATTrainer.save_pretrained`` restores against a
fresh build (``from_pretrained_adapter``); ``model_config_dict`` writes the
export's ``config.json`` and :func:`load_pretrained` rebuilds the model
from it. ``build_model`` records the run's ``audio_encoder_type`` on the
model, so the export's ``config.json`` names it (JAX's ``build_model``
leaves the model's default, ``"hubert"``, there, and its
``load_pretrained`` then cannot rebuild an EfficientNet export).

The weights go to ``device``: ``cuda:0`` when it is None, and without a GPU
the build functions raise (after their refusals and the check that a
checkpoint directory exists, before any weight is drawn or read); ``device="cpu"``
builds for the plain versions. :func:`build_tokenizer` needs the
``transformers`` package, as in JAX, and raises ``RuntimeError`` without it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.models import llama as llm
from aat_tpu_torch.models.aslm import AslmConfig, AslmModel, PoolingConfig, init_aslm_params
from aat_tpu_torch.runtime.device import resolve_device
from aat_tpu_torch.training import checkpoint as ckpt_lib
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.optim import tree_map
from aat_tpu_torch.utils import port

logger = logging.getLogger(__name__)

ENCODER_KEY = (0, 0)  # jax.random.key_data(PRNGKey(0))
DECODER_KEY = (0, 1)  # jax.random.key_data(PRNGKey(1))


def _on(tree, device):
    return tree_map(lambda x: x.to(device), tree)


def build_audio_encoder(config: TrainingConfig, pretrained: bool = True, device=None):
    """→ (params, config) for ``config.audio_encoder_type``: hubert
    (hubert-large) or wav2vec2 (wav2vec2-large), read from the local
    checkpoint directory ``audio_encoder_checkpoint`` when ``pretrained``;
    or efficient_net (b0: ``efficientnet_pytorch`` when ``pretrained``,
    else, or without that package, the seeded random init)."""
    if config.audio_encoder_type == "efficient_net":
        from aat_tpu_torch.models.efficientnet import build_efficientnet_encoder

        return build_efficientnet_encoder(pretrained, resolve_device(device))
    if config.audio_encoder_type not in ("hubert", "wav2vec2"):
        raise ValueError(f"unknown audio_encoder_type: {config.audio_encoder_type}")

    def apply_remat(cfg):
        return dataclasses.replace(cfg, remat=config.encoder_remat,
                                   remat_policy=config.encoder_remat_policy)

    if pretrained:
        path = port.require_local_dir(config.audio_encoder_checkpoint, "audio encoder checkpoint")
        device = resolve_device(device)
        params, cfg = port.port_hubert(path, config.audio_encoder_type)
        return _on(params, device), apply_remat(dataclasses.replace(cfg, attention_impl="pallas"))
    cfg = (hub.hubert_large_config() if config.audio_encoder_type == "hubert"
           else hub.wav2vec2_large_config())
    return hub.init_hubert_params(ENCODER_KEY, cfg, resolve_device(device)), apply_remat(cfg)


def build_lm_decoder(config: TrainingConfig, pretrained: bool = True, device=None):
    """→ (params, LlamaConfig): read from the local checkpoint directory
    ``lm_pretrained_model`` when ``pretrained``, else random Qwen-1.5-1.8B
    when it names Qwen and SmolLM-135M otherwise."""
    if pretrained:
        path = port.require_local_dir(config.lm_pretrained_model, "LM checkpoint")
        device = resolve_device(device)
        params, cfg = port.port_llama(path)
        return _on(params, device), dataclasses.replace(cfg, attention_impl="pallas")
    name = config.lm_pretrained_model.lower()
    cfg = llm.qwen15_18b_config() if "qwen" in name else llm.smollm_135m_config()
    return llm.init_llama_params(DECODER_KEY, cfg, resolve_device(device)), cfg


def build_tokenizer(config: TrainingConfig):
    """The HF tokenizer of the local directory ``lm_pretrained_model``, with
    BOS and EOS added and Qwen's ``<|im_start|>`` / ``<|im_end|>`` as BOS /
    EOS (JAX ``build_tokenizer``)."""
    try:
        import transformers
    except ImportError as exc:
        raise RuntimeError("the tokenizer needs the `transformers` package, which is not "
                           "installed") from exc
    path = port.require_local_dir(config.lm_pretrained_model, "tokenizer")
    tokenizer = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
    tokenizer.add_bos_token = True
    tokenizer.add_eos_token = True
    if "qwen" in config.lm_pretrained_model.lower():
        tokenizer.bos_token_id = tokenizer.encode("<|im_start|>")[0]
        tokenizer.eos_token_id = tokenizer.encode("<|im_end|>")[0]
    return tokenizer


def model_config_dict(model: AslmModel, config: TrainingConfig, saved_subtrees) -> dict:
    """The export's ``config.json``: every config needed to rebuild the
    model plus the checkpoints it came from, under the JAX package's keys
    (``aat_tpu/models/build.py`` ``model_config_dict``; the nested configs
    carry the port's fields)."""
    return {
        "model_type": "aslm",
        "aslm": dataclasses.asdict(model.config),
        "audio_encoder_type": model.audio_encoder_type,
        "audio_encoder_config": dataclasses.asdict(model.audio_encoder_config),
        "lm_config": dataclasses.asdict(model.lm_config),
        "audio_encoder_checkpoint": config.audio_encoder_checkpoint,
        "lm_pretrained_model": config.lm_pretrained_model,
        "saved_subtrees": list(saved_subtrees),
    }


def build_model(config: TrainingConfig, pretrained: bool = True,
                from_pretrained_adapter=None, seed: int = 0, device=None):
    """→ (AslmModel, params): the encoder and decoder of
    :func:`build_audio_encoder` / :func:`build_lm_decoder` and a fresh
    adapter (``init_aslm_params(PRNGKey(seed))``), or the adapter of the
    export at ``from_pretrained_adapter`` (``AATTrainer.save_pretrained``)
    restored against it: the same paths and shapes, or it raises. The
    ``AslmConfig`` takes ``projection_type`` and the default
    ``PoolingConfig``. Freezing is the trainer's freeze mask, as in JAX."""
    enc_params, enc_cfg = build_audio_encoder(config, pretrained, device)
    lm_params, lm_cfg = build_lm_decoder(config, pretrained, device)
    aslm_cfg = AslmConfig(
        projection_type=config.projection_type,
        audio_encoder_embeddings_seq_len=config.audio_encoder_embeddings_seq_len,
        audio_encoder_hidden=enc_cfg.hidden_size, lm_hidden=lm_cfg.hidden_size)
    device = resolve_device(device)
    adapter = init_aslm_params((0, int(seed)), aslm_cfg, device)
    if from_pretrained_adapter is not None:
        path = os.path.abspath(from_pretrained_adapter)
        saved = ckpt_lib.read_params(path, device)["params"]
        adapter = ckpt_lib.unflatten_like(adapter, saved, "adapter.")
        logger.info("loaded adapter from %s", path)
    model = AslmModel(aslm_cfg, enc_cfg, lm_cfg, audio_encoder_type=config.audio_encoder_type)
    return model, {"audio_encoder": enc_params, "adapter": adapter, "lm_decoder": lm_params}


def _detuple(d: dict) -> dict:
    """JSON turns tuples into lists; the configs hold tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def load_pretrained(path: str, pretrained_missing: bool = False, seed: int = 0, device=None):
    """→ (AslmModel, params) rebuilt from an ``AATTrainer.save_pretrained``
    export (``config.json`` and ``params.pt``) alone. Subtrees the export
    lacks (frozen at save time) are read from the checkpoints that
    ``config.json`` records when ``pretrained_missing`` (local directories),
    and otherwise drawn at random (the port's int-seed init of ``seed``),
    with a warning."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        desc = json.load(f)
    enc_type = desc["audio_encoder_type"]
    aslm_kw = dict(desc["aslm"])
    if "pooling" in aslm_kw:
        aslm_kw["pooling"] = PoolingConfig(**aslm_kw["pooling"])
    if enc_type == "efficient_net":
        from aat_tpu_torch.models.efficientnet import EfficientNetConfig

        enc_cfg = EfficientNetConfig(**_detuple(desc["audio_encoder_config"]))
    else:
        enc_cfg = hub.HubertConfig(**_detuple(desc["audio_encoder_config"]))
    model = AslmModel(AslmConfig(**aslm_kw), enc_cfg,
                      llm.LlamaConfig(**_detuple(desc["lm_config"])), audio_encoder_type=enc_type)
    saved = set(desc["saved_subtrees"])
    missing = {"audio_encoder", "adapter", "lm_decoder"} - saved
    device = resolve_device(device)
    params = model.init_params(seed, device)
    if missing and pretrained_missing:
        tc = TrainingConfig(audio_encoder_type=enc_type,
                            audio_encoder_checkpoint=desc["audio_encoder_checkpoint"],
                            lm_pretrained_model=desc["lm_pretrained_model"])
        if "audio_encoder" in missing:
            params["audio_encoder"], _ = build_audio_encoder(tc, True, device)
        if "lm_decoder" in missing:
            params["lm_decoder"], _ = build_lm_decoder(tc, True, device)
    elif missing:
        logger.warning("export %s lacks %s; using random init (pass pretrained_missing=True "
                       "to read the recorded checkpoints)", path, sorted(missing))
    flat = ckpt_lib.read_params(path, device)["params"]
    for key in saved:
        params[key] = ckpt_lib.unflatten_like(params[key], flat, f"{key}.")
    logger.info("loaded pretrained ASLM from %s (saved subtrees: %s)", path, sorted(saved))
    return model, params
